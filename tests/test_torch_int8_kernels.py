"""The plain versions of the port's int8 kernels against the TPU kernels they
port, run in interpret mode on the CPU as the JAX package's own tests run
them, on the same seeded inputs and the same int8 weights
(``quantize_weight``, bit-equal to the JAX package's) with bf16 scales:

* int8 decode attention (``ops/decode_attention_int8.py``) against #3
  ``flash_gqa_decode_tiled`` at the v0 GQA geometry (H=9, KV=3, hd=64) and
  against #2 ``flash_gqa_decode``'s int8 branch at the tiny geometry. The
  TPU kernels read a packed [K | V] int8 cache with merged scales and a
  window of extra positions; that layout is built here only: the cache
  holds positions [0, n) and E bf16 rows (the flush window's pending rows
  and the step's own; E = 1, and E = 4 and 8 for #3) ride as the extra
  rows. Tolerance 1e-2 x max|ref|: both sides quantize q and w at the
  same points, but exp and the sums round in another order, so a w8 level
  can move by one and the bf16 output by an ulp (read: <= 0.6 %).
* the ``kv_quant`` mode of the attention block against #4
  ``fused_attn_block(kv_quant=True)``, the W8A8 attention block against #5
  ``fused_attn_block_w8a8`` (with and without ``kv_quant``) and the W8A8
  MLP block against #7 ``fused_mlp_block_w8a8``. The block outputs within
  1e-2 x max|ref| (the fp32 norm and sums round in another order, which
  can move an int8 activation by one level; read: <= 0.6 %). The int8 k/v
  rows within one level and the v scales bit-equal; the k scales within
  2^-7 relative, one bf16 ulp of the row's max, because RoPE is rounded
  once here and after each of its three steps on the TPU.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mellow_tpu.config import LlamaConfig
from mellow_tpu.models.llama import rope_tables
from mellow_tpu.ops.pallas_attn_block import fused_attn_block, fused_attn_block_w8a8
from mellow_tpu.ops.pallas_decode_attention import (
    HEAD_PAD, build_q_tiled, extract_o_tiled, flash_gqa_decode, flash_gqa_decode_tiled, lane_pad)
from mellow_tpu.ops.pallas_mlp_block import fused_mlp_block_w8a8
from mellow_tpu_torch.models.llama import quantize_kv, quantize_weight
from mellow_tpu_torch.ops import attn_block as ab
from mellow_tpu_torch.ops import attn_block_w8a8 as aw
from mellow_tpu_torch.ops import decode_attention_int8 as di
from mellow_tpu_torch.ops import mlp_block_w8a8 as mw

TOL = 1e-2


def _jb(t):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(ours, theirs, tol=TOL):
    ours = ours.float().numpy()
    assert ours.shape == theirs.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours, theirs, atol=tol * np.abs(theirs).max(), rtol=0)


# ---------------------------------------------------------------------------
# int8 decode attention
# ---------------------------------------------------------------------------

def _decode_inputs(seed, B, H, KV, hd, n, E=1):
    """bf16 q, and an int8 cache of n positions made by quantize_kv from
    bf16 rows, plus E bf16 extra rows (B, E, KV, hd): the positions after
    n, unquantized."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy((rng.randn(B, H, hd) * 0.5).astype(np.float32)).bfloat16()
    k = torch.from_numpy((rng.randn(B, n + E + 2, KV * hd) * 0.5).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.randn(B, n + E + 2, KV * hd).astype(np.float32)).bfloat16()
    k8, ks = quantize_kv(k)
    v8, vs = quantize_kv(v)
    k8[:, n:] = 127  # positions from n on must not be read
    v8[:, n:] = -127
    extra = (k[:, n:n + E].reshape(B, E, KV, hd), v[:, n:n + E].reshape(B, E, KV, hd))
    return q, k8.reshape(B, -1, KV, hd), v8.reshape(B, -1, KV, hd), ks, vs, extra


def _packed(k8, v8, ks, vs, cur, n):
    """The TPU kernels' packed layout: [K | V] int8 rows, merged scales,
    the E extra rows as extra rows [0, E)."""
    B, _, KV, hd = k8.shape
    KL = KV * hd
    S8 = -(-n // 8) * 8
    SP = lane_pad(S8)
    kv = np.zeros((1, B, S8, 2 * KL), np.int8)
    kv[0, :, :n, :KL] = k8[:, :n].reshape(B, n, KL).numpy()
    kv[0, :, :n, KL:] = v8[:, :n].reshape(B, n, KL).numpy()
    sc = np.zeros((1, B, 2 * SP), np.float32)
    sc[0, :, :n] = ks[:, :n].numpy()
    sc[0, :, SP:SP + n] = vs[:, :n].numpy()
    E = cur[0].shape[1]
    extra = np.zeros((B, 8, 2 * KL), np.float32)
    extra[:, :E, :KL] = cur[0].float().reshape(B, E, KL).numpy()
    extra[:, :E, KL:] = cur[1].float().reshape(B, E, KL).numpy()
    return jnp.asarray(kv), jnp.asarray(sc), jnp.asarray(extra, jnp.bfloat16)


@pytest.mark.parametrize(
    "kernel, H, KV, hd, n, E",
    [("tiled", 9, 3, 64, 9, 1), ("tiled", 9, 3, 64, 17, 1), ("full", 4, 2, 16, 9, 1),
     ("full", 4, 2, 16, 17, 1), ("tiled", 9, 3, 64, 17, 4), ("tiled", 9, 3, 64, 9, 8)],
    ids=["tiled-v0geom-n9", "tiled-v0geom-n17", "full-tiny-n9", "full-tiny-n17", "tiled-v0geom-n17-e4",
         "tiled-v0geom-n9-e8"],
)
def test_int8_decode_plain_matches_tpu_kernel(kernel, H, KV, hd, n, E):
    B, rep = 2, H // KV
    q, k8, v8, ks, vs, cur = _decode_inputs(n + H, B, H, KV, hd, n, E)
    ours = di.decode_attention_int8_plain(q, k8, v8, ks, vs, n, *cur)
    kv, sc, extra = _packed(k8, v8, ks, vs, cur, n)
    args = (kv, sc, extra, jnp.int32(0), jnp.int32(n), jnp.int32(E))
    if kernel == "tiled":
        out = flash_gqa_decode_tiled(build_q_tiled(_jb(q).reshape(B, KV, rep, hd)), *args,
                                     head_dim=hd, interpret=True)
        theirs = _f32(extract_o_tiled(out)).reshape(B, H, hd)
    else:
        qd = np.zeros((B, HEAD_PAD, 2 * KV * hd), np.float32)
        for h in range(H):
            qd[:, h, (h // rep) * hd:(h // rep + 1) * hd] = q[:, h].float().numpy()
        o = _f32(flash_gqa_decode(jnp.asarray(qd, jnp.bfloat16), *args, head_dim=hd,
                                  interpret=True))[:, :H, KV * hd:]
        theirs = np.stack([o[:, h, (h // rep) * hd:(h // rep + 1) * hd] for h in range(H)], axis=1)
    assert ours.dtype == torch.bfloat16
    _close(ours, theirs)


def test_int8_decode_dispatch_uses_plain_version_on_cpu():
    q, k8, v8, ks, vs, cur = _decode_inputs(1, 2, 4, 2, 16, 6)
    before = di.LAUNCHES
    out = di.decode_attention_int8(q, k8, v8, ks, vs, 6, *cur)
    assert di.LAUNCHES == before
    torch.testing.assert_close(out, di.decode_attention_int8_plain(q, k8, v8, ks, vs, 6, *cur),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        di.decode_attention_int8_cuda(q, k8, v8, ks, vs, 6, *cur)


@pytest.mark.parametrize("rep, hd, n_top", [(3, 64, di.MAX_N), (1, 16, di.MAX_N), (8, 128, 20000)])
def test_int8_decode_cluster_rule_and_shared_memory(rep, hd, n_top):
    """#3's launch over a grid of n (the batch only sizes the grid, one
    cluster per KV group and batch row): about 48 positions a block up to
    16 blocks, and every block's slice within the shared memory a launch
    may ask for, at v0's geometry (rep 3, hd 64) up to the most positions
    whose int32 sums cannot overflow (the single-block kernel stopped near
    12,000); the refusals past that, at a slice too long for one block and
    at a cluster outside 1..16."""
    for n in (1, 7, 47, 48, 49, 96, 389, 413, 420, 768, 769, 4096, n_top):
        blocks, shared = di.cluster_launch(rep, hd, n)
        assert blocks == min(16, -(-n // 48)) == di.cluster_blocks(n)
        assert -(-n // blocks) <= 48 or blocks == 16
        assert 0 < shared == di.shared_bytes(rep, hd, n, blocks) <= di.MAX_SHARED
    with pytest.raises(ValueError, match="overflow"):
        di.cluster_launch(rep, hd, di.MAX_N + 1)
    with pytest.raises(ValueError, match="shared memory"):
        di.cluster_launch(rep, hd, 60000, blocks=1)
    for blocks in (0, 17):
        with pytest.raises(ValueError, match="outside"):
            di.cluster_launch(rep, hd, 389, blocks=blocks)


# ---------------------------------------------------------------------------
# prefill blocks
# ---------------------------------------------------------------------------

B, S, D, H, KV, HD, I = 2, 13, 64, 4, 2, 16, 128
KW = dict(num_heads=H, num_kv_heads=KV, head_dim=HD, eps=1e-5)


def _block_inputs():
    rng = np.random.RandomState(6)
    cos, sin = rope_tables(LlamaConfig(head_dim=HD), S)
    shapes = dict(wq=(D, H * HD), wk=(D, KV * HD), wv=(D, KV * HD), wo=(H * HD, D),
                  w_gate=(D, I), w_up=(D, I), w_down=(I, D))
    w = {k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32)) for k, s in shapes.items()}
    bf = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()  # noqa: E731
    return {
        "x": bf(rng.randn(B, S, D) * 0.5), "ln": bf(rng.randn(D) * 0.1 + 1.0),
        "cos": bf(cos), "sin": bf(sin),
        "dense": {k: v.bfloat16() for k, v in w.items()},
        # int8 values and per-column scales, the scales cast to bf16.
        "int8": {k: (q["q"], q["scale"].bfloat16()) for k, q in
                 ((k, quantize_weight(v)) for k, v in w.items())},
    }


def _jax_w8(pairs):
    return [jnp.asarray(t.numpy()) if t.dtype == torch.int8 else _jb(t) for p in pairs for t in p]


def _check_kv(ours, theirs):
    """ours: (k8, v8, k_scale, v_scale) torch; theirs: the TPU kernel's
    (k8, v8, (B, 1, SP) scales)."""
    k8, v8, ks, vs = ours
    for got, want in ((k8, theirs[0]), (v8, theirs[1])):
        assert got.dtype == torch.int8 and got.shape == want.shape
        assert np.abs(got.numpy().astype(int) - np.asarray(want).astype(int)).max() <= 1
    jks, jvs = (np.asarray(t)[:, 0, :S] for t in theirs[2:])
    np.testing.assert_array_equal(vs.numpy(), jvs)
    np.testing.assert_allclose(ks.numpy(), jks, rtol=2.0 ** -7, atol=0)


@pytest.fixture(scope="module")
def blocks():
    a = _block_inputs()
    x, ln, cos, sin = a["x"], a["ln"], a["cos"], a["sin"]
    j = [_jb(t) for t in (x, ln, cos, sin)]
    dense = [a["dense"][k] for k in ("wq", "wk", "wv", "wo")]
    attn8 = [a["int8"][k] for k in ("wq", "wk", "wv", "wo")]
    mlp8 = [a["int8"][k] for k in ("w_gate", "w_up", "w_down")]
    flat8 = [t for p in attn8 for t in p]
    return {
        "attn_block kv_quant": (
            ab.attn_block_plain(x, ln, *dense, cos, sin, **KW, kv_quant=True),
            fused_attn_block(j[0], j[1], *(_jb(t) for t in dense), j[2], j[3], **KW,
                             kv_quant=True, interpret=True)),
        "attn_block_w8a8": (
            aw.attn_block_w8a8_plain(x, ln, *flat8, cos, sin, **KW),
            fused_attn_block_w8a8(j[0], j[1], *_jax_w8(attn8), j[2], j[3], **KW, interpret=True)),
        "attn_block_w8a8 kv_quant": (
            aw.attn_block_w8a8_plain(x, ln, *flat8, cos, sin, **KW, kv_quant=True),
            fused_attn_block_w8a8(j[0], j[1], *_jax_w8(attn8), j[2], j[3], **KW, kv_quant=True,
                                  interpret=True)),
        "mlp_block_w8a8": (
            (mw.mlp_block_w8a8_plain(x, ln, *(t for p in mlp8 for t in p), eps=1e-5),),
            (fused_mlp_block_w8a8(j[0], j[1], *_jax_w8(mlp8), eps=1e-5, interpret=True),)),
    }


@pytest.mark.parametrize("name", ["attn_block kv_quant", "attn_block_w8a8", "attn_block_w8a8 kv_quant",
                                  "mlp_block_w8a8"])
def test_block_plain_matches_tpu_kernel(blocks, name):
    ours, theirs = blocks[name]
    _close(ours[0], _f32(theirs[0]))
    if "kv_quant" in name:
        _check_kv(ours[1:], theirs[1:])
    elif len(ours) > 1:  # bf16 k and v
        for got, want in zip(ours[1:], theirs[1:]):
            _close(got, _f32(want))


def test_block_dispatch_writes_int8_cache_on_cpu():
    a = _block_inputs()
    attn8 = [t for k in ("wq", "wk", "wv", "wo") for t in a["int8"][k]]
    cache = torch.zeros((2, B, S + 5, KV, HD), dtype=torch.int8)
    scales = torch.zeros((2, B, S + 5), dtype=torch.float32)
    before = (ab.LAUNCHES_KV_QUANT, aw.LAUNCHES)
    out = aw.attn_block_w8a8(a["x"], a["ln"], *attn8, a["cos"], a["sin"], **KW, k_out=cache[0, :, :S],
                             v_out=cache[1, :, :S], kv_quant=True, k_scale_out=scales[0, :, :S],
                             v_scale_out=scales[1, :, :S])
    assert (ab.LAUNCHES_KV_QUANT, aw.LAUNCHES) == before
    ref = aw.attn_block_w8a8_plain(a["x"], a["ln"], *attn8, a["cos"], a["sin"], **KW, kv_quant=True)
    for got, want in zip(out, ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(cache[0, :, :S].reshape(B, S, -1), ref[1], rtol=0, atol=0)
    torch.testing.assert_close(scales[1, :, :S], ref[4], rtol=0, atol=0)
    assert cache[:, :, S:].abs().sum() == 0 and scales[:, :, S:].abs().sum() == 0
    mlp8 = [t for k in ("w_gate", "w_up", "w_down") for t in a["int8"][k]]
    before = mw.LAUNCHES
    torch.testing.assert_close(mw.mlp_block_w8a8(a["x"], a["ln"], *mlp8, eps=1e-5),
                               mw.mlp_block_w8a8_plain(a["x"], a["ln"], *mlp8, eps=1e-5), rtol=0, atol=0)
    assert mw.LAUNCHES == before


def test_int8_cuda_wrappers_reject_cpu_tensors():
    a = _block_inputs()
    attn8 = [t for k in ("wq", "wk", "wv", "wo") for t in a["int8"][k]]
    mlp8 = [t for k in ("w_gate", "w_up", "w_down") for t in a["int8"][k]]
    dense = [a["dense"][k] for k in ("wq", "wk", "wv", "wo")]
    with pytest.raises(ValueError, match="CUDA"):
        aw.attn_block_w8a8_cuda(a["x"], a["ln"], *attn8, a["cos"], a["sin"], **KW)
    with pytest.raises(ValueError, match="CUDA"):
        mw.mlp_block_w8a8_cuda(a["x"], a["ln"], *mlp8, eps=1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        ab.attn_block_cuda(a["x"], a["ln"], *dense, a["cos"], a["sin"], **KW, kv_quant=True)


def test_mm8_sums_exactly():
    """The plain int8 product equals the exact integer product rounded once
    to fp32 (the kernels' int32 sums), at the MLP's down-projection depth,
    where fp32 sums of int8 products would round."""
    from mellow_tpu_torch.ops.int8 import mm8

    rng = np.random.RandomState(7)
    a = torch.from_numpy(rng.randint(-127, 128, (5, 1536)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-127, 128, (1536, 7)).astype(np.int8))
    a[0] = 127
    w[:, 0] = 127
    exact = (a.long() @ w.long()).float()
    torch.testing.assert_close(mm8(a, w), exact, rtol=0, atol=0)
