"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card. Skipped where there is no CUDA device. This file imports no
JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_kernels.py

Tolerances: the log-mel within atol 5e-4 dB / rtol 1e-4, what the TPU
kernel is held to (fp32 DFT sums of 1024 terms in another order); the bf16
and int8 kernels' bf16 outputs within 2e-2 x max|plain| (both round at the
same points; the sums run in another order, so a value may round to the
neighbouring bf16, or an int8 activation to the neighbouring level); int8
k/v rows within one level of the plain version and their scales within
2^-7 relative (one bf16 ulp of the row's max).

The kernels this file's digests name must give, bit for bit, the outputs
recorded on an NVIDIA H100 from the same seeded inputs: #3 with one extra
row at a cluster of one block (recorded from the kernel before the int8
flush window and the redesigns of #2 and #10; #3's other cluster sizes
stay within one bf16 ulp of it); #4 and #4 ``kv_quant`` as recorded from
their redesign onto ``proj_mma_core.cuh`` and ``flash_prefill_core.cuh``
(the fp32 order of their bf16 products moved); #5, whole and its int8 k/v
rows and scales alone, as recorded from the chain before that redesign,
which the redesign keeps bit for bit (exact int32 sums, the same
quantizer order, the same attention arithmetic); #6 and #8 at v0's stages
1-3 as recorded from their redesign onto ``proj_mma_core.cuh``'s dense
products and ``window_mma_core.cuh`` (the K split of the residual
products and the softmax's sum order moved a few bits; their digests from
the kernels before it are in the history of this file); #9 at hd 64 and
24 as recorded from the kernel before that redesign, which keeps its
arithmetic; #7 at v0's prefill, B=1 and B=4, as recorded from the
four-launch chain (two row quantizers around two wmma GEMMs) before its
redesign onto ``proj_mma_core.cuh``'s int8 path, which keeps them bit for
bit (exact int32 sums, rowquant's arithmetic in both fused quantizers, the
same silu). The seeded inputs and the digest cases are in
``tests/torch_kernel_cases.py``, which ``chip_smoke.py --ab`` runs too."""

import numpy as np
import pytest
import torch

from mellow_tpu_torch.config import FrontendConfig
from mellow_tpu_torch.ops import frontend as fe
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
from torch_kernel_cases import GRAD_REFUSALS, refuses_grad
from torch_kernel_cases import bf16 as _bf16
from torch_kernel_cases import digest as _digest
from torch_kernel_cases import digest_case as _digest_case
from torch_kernel_cases import int8_decode_inputs as _int8_decode_inputs
from torch_kernel_cases import int8_weight as _int8
from torch_kernel_cases import rope as _rope

pytestmark = pytest.mark.cuda

CFG = FrontendConfig()


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _wave(b, seed, device):
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(b, CFG.num_samples) * 0.1).astype(np.float32)).to(device)


@pytest.mark.parametrize("name", GRAD_REFUSALS)
def test_kernel_refuses_inputs_that_require_grad(device, name):
    """No kernel has a backward: each CUDA wrapper raises on an input that
    requires grad, before it launches."""
    refuses_grad(name, device)


@pytest.mark.parametrize("batch", [1, 2, 3, 4])
def test_log_mel_kernel_matches_plain_version(device, batch):
    wave = _wave(batch, batch, device)
    out = melspec.log_mel_cuda(wave, CFG)
    torch.cuda.synchronize()
    ref = fe.log_mel_spectrogram(wave, CFG)
    assert out.shape == (batch, 1001, 64)
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=1e-4)


def test_log_mel_auto_launches_the_kernel_on_cuda(device):
    wave = _wave(1, 7, device)
    before = melspec.LAUNCHES
    out = fe.log_mel_auto(wave, CFG)
    assert melspec.LAUNCHES == before + 1
    torch.testing.assert_close(out, fe.log_mel_spectrogram(wave, CFG), atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize(
    "make",
    [
        lambda w: w.double(),
        lambda w: w[:, : CFG.n_fft // 2],  # too short to reflect-pad
        lambda w: torch.cat([w, w], dim=1)[:, ::2],
    ],
    ids=["float64", "short", "strided"],
)
def test_log_mel_kernel_rejects_what_it_does_not_take(device, make):
    with pytest.raises(ValueError):
        melspec.log_mel_cuda(make(_wave(1, 8, device)), CFG)


@pytest.mark.parametrize("B, T", [(2, 513), (1, 160007)])
def test_log_mel_kernel_at_odd_lengths(device, B, T):
    """The shortest wave the reflect padding takes and an odd length: the
    FFT kernel within the TPU kernel's tolerance of the plain version's
    dense DFT."""
    rng = np.random.RandomState(T + B)
    wave = torch.from_numpy((rng.randn(B, T) * 0.1).astype(np.float32)).to(device)
    out = melspec.log_mel_cuda(wave, CFG)
    torch.cuda.synchronize()
    assert out.shape == (B, 1 + T // 320, 64)
    torch.testing.assert_close(out, fe.log_mel_spectrogram(wave, CFG), atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize("seconds", [3, 15])
def test_log_mel_kernel_takes_other_lengths(device, seconds):
    """The infer-mode (3 s) and long-audio (15 s) waves: 1 + T // 320 frames."""
    rng = np.random.RandomState(seconds)
    wave = torch.from_numpy((rng.randn(2, seconds * 32000) * 0.1).astype(np.float32)).to(device)
    out = melspec.log_mel_cuda(wave, CFG)
    torch.cuda.synchronize()
    assert out.shape == (2, 1 + seconds * 100, 64)
    torch.testing.assert_close(out, fe.log_mel_spectrogram(wave, CFG), atol=5e-4, rtol=1e-4)


BF16_TOL = 2e-2


def _close_bf16(out, ref):
    assert out.shape == ref.shape and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= BF16_TOL * ref.float().abs().max().item(), err


@pytest.mark.parametrize("B, n", [(1, 389), (4, 420), (2, 7)])
def test_decode_attention_kernel_matches_plain_version(device, B, n):
    rng = np.random.RandomState(n)
    H, KV, hd, s_max = 9, 3, 64, 450
    q = _bf16(rng, B, H, hd)
    k = _bf16(rng, 2, B, s_max, KV, hd)[1]  # a layer view of a cache, as in decode
    v = _bf16(rng, 2, B, s_max, KV, hd)[1]
    before = da.LAUNCHES
    out = da.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    _close_bf16(out, da.decode_attention_plain(q, k, v, n))


@pytest.mark.parametrize("B, S", [(1, 389), (2, 100), (1, 13)])
def test_attn_block_kernel_matches_plain_version(device, B, S):
    rng = np.random.RandomState(S)
    D, H, KV, hd = 576, 9, 3, 64
    x = _bf16(rng, B, S, D, scale=0.5)
    ws = [_bf16(rng, D, scale=0.1) + 1, _bf16(rng, D, H * hd, scale=0.05),
          _bf16(rng, D, KV * hd, scale=0.05), _bf16(rng, D, KV * hd, scale=0.05),
          _bf16(rng, H * hd, D, scale=0.05)]
    t = torch.arange(S, dtype=torch.float32, device="cuda")[:, None]
    inv = 1.0 / (100000.0 ** (torch.arange(0, hd, 2, device="cuda").float() / hd))
    emb = torch.cat([t * inv, t * inv], dim=-1)
    cos, sin = emb.cos().bfloat16(), emb.sin().bfloat16()
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=1e-5)
    cache = torch.zeros((2, B, S + 8, KV, hd), dtype=torch.bfloat16, device="cuda")
    before = ab.LAUNCHES
    out, k, v = ab.attn_block(x, *ws, cos, sin, **kw, k_out=cache[0, :, :S], v_out=cache[1, :, :S])
    torch.cuda.synchronize()
    assert ab.LAUNCHES == before + 1
    ref = ab.attn_block_plain(x, *ws, cos, sin, **kw)
    for got, want in zip((out, k, v), ref):
        _close_bf16(got, want)
    assert cache[:, :, S:].abs().sum().item() == 0


@pytest.mark.parametrize("B, S", [(1, 389), (4, 389), (2, 13)])
def test_mlp_block_kernel_matches_plain_version(device, B, S):
    rng = np.random.RandomState(S + B)
    D, I = 576, 1536
    args = [_bf16(rng, B, S, D, scale=0.5), _bf16(rng, D, scale=0.1) + 1,
            _bf16(rng, D, I, scale=0.05), _bf16(rng, D, I, scale=0.05), _bf16(rng, I, D, scale=0.05)]
    before = mb.LAUNCHES
    out = mb.mlp_block(*args, eps=1e-5)
    torch.cuda.synchronize()
    assert mb.LAUNCHES == before + 1
    _close_bf16(out, mb.mlp_block_plain(*args, eps=1e-5))


# v0's widths from one row to S = 1024; then D = 64 (two K tiles, one
# column tile of the down product) with I = 128, and D = 768 with I = 2048.
MLP_SHAPES = ([(S, B, 576, 1536) for S in (1, 13, 64, 389, 1024) for B in (1, 4)]
              + [(S, B, D, I) for D, I in ((64, 128), (768, 2048)) for S in (13, 389) for B in (1, 4)])


@pytest.mark.parametrize("S, B, D, I", MLP_SHAPES)
def test_mlp_block_kernel_at_every_shape(device, S, B, D, I):
    """#6 at the main path's shapes and at other widths and row counts, down
    to one row (a row tile of 64 with 63 rows past M)."""
    rng = np.random.RandomState(S + 7 * B + D)
    args = [_bf16(rng, B, S, D, scale=0.5), _bf16(rng, D, scale=0.1) + 1,
            _bf16(rng, D, I, scale=0.05), _bf16(rng, D, I, scale=0.05), _bf16(rng, I, D, scale=0.05)]
    out = mb.mlp_block_cuda(*args, eps=1e-5)
    torch.cuda.synchronize()
    _close_bf16(out, mb.mlp_block_plain(*args, eps=1e-5))


@pytest.mark.parametrize("B", [1, 2, 4])
@pytest.mark.parametrize("shifted", [False, True], ids=["W-MSA", "SW-MSA"])
@pytest.mark.parametrize("R, C, H", [(64, 96, 4), (32, 192, 8), (16, 384, 16), (64, 256, 4)],
                         ids=["v0-stage1", "v0-stage2", "v0-stage3", "large-stage1"])
def test_swin_block_kernel_at_every_stage(device, R, C, H, shifted, B):
    """#8 at every stage that takes it on the main path (v0's 1-3, hd = 24;
    HTSAT-large's 1, hd = 64), with and without the shift mask."""
    from torch_kernel_cases import swin_inputs

    x, p, bias, mask = swin_inputs(np.random.RandomState(R + C + B), B, R, C, H, shifted)
    out = sb.swin_block_cuda(x, p, bias, mask, num_heads=H, window_size=8)
    torch.cuda.synchronize()
    _close_bf16(out, sb.swin_block_plain(x, p, bias, mask, num_heads=H, window_size=8))


@pytest.mark.parametrize("B, R, C, H, shift", [(1, 64, 96, 4, 4), (2, 32, 192, 8, 0), (1, 16, 384, 16, 4),
                                                (1, 64, 256, 4, 4), (2, 64, 256, 4, 0)])
def test_swin_block_kernel_matches_plain_version(device, B, R, C, H, shift):
    from mellow_tpu_torch.models.htsat import shifted_window_mask

    rng = np.random.RandomState(R)

    def lin(i, o):
        return {"kernel": _bf16(rng, i, o, scale=0.05), "bias": _bf16(rng, o, scale=0.02)}

    def ln():
        return {"scale": _bf16(rng, C, scale=0.1) + 1, "bias": _bf16(rng, C, scale=0.02)}

    p = {"norm1": ln(), "qkv": lin(C, 3 * C), "proj": lin(C, C), "norm2": ln(),
         "fc1": lin(C, 4 * C), "fc2": lin(4 * C, C)}
    x = _bf16(rng, B, R, R, C, scale=0.5)
    bias = _bf16(rng, H, 64, 64, scale=0.5).float()
    mask = torch.from_numpy(shifted_window_mask(R, 8, shift)).cuda() if shift else None
    before = sb.LAUNCHES
    out = sb.swin_block(x, p, bias, mask, num_heads=H, window_size=8)
    torch.cuda.synchronize()
    assert sb.LAUNCHES == before + 1
    _close_bf16(out, sb.swin_block_plain(x, p, bias, mask, num_heads=H, window_size=8))


@pytest.mark.parametrize("rep", [1, 3, 8])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("n", [1, 7, 63, 64, 389, 420, 4096])
def test_decode_attention_kernel_at_every_length(device, n, B, rep):
    """The cluster split at the lengths around its block edges, at the
    v0 prefix lengths and at a long cache, for H/KV of 1, 3 and 8."""
    rng = np.random.RandomState(n + 10 * B + rep)
    KV, hd = 3, 64
    q = _bf16(rng, B, KV * rep, hd)
    k = _bf16(rng, B, n + 8, KV, hd)
    v = _bf16(rng, B, n + 8, KV, hd)
    before = da.LAUNCHES
    out = da.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    _close_bf16(out, da.decode_attention_plain(q, k, v, n))


@pytest.mark.parametrize("n, blocks", [(40, 1), (340, 8), (800, 16)])
def test_decode_attention_kernel_at_every_cluster_size(device, n, blocks):
    """A cluster of 1, the portable 8 and the non-portable 16 blocks, as the
    wrapper takes them from n."""
    assert da.cluster_blocks(n) == blocks
    rng = np.random.RandomState(n + blocks)
    H, KV, hd = 9, 3, 64
    q = _bf16(rng, 2, H, hd)
    k = _bf16(rng, 2, n + 3, KV, hd)
    v = _bf16(rng, 2, n + 3, KV, hd)
    out = da.decode_attention_cuda(q, k, v, n)
    torch.cuda.synchronize()
    _close_bf16(out, da.decode_attention_plain(q, k, v, n))


@pytest.mark.parametrize("blocks", [8, 16])
def test_decode_attention_kernel_with_blocks_past_n(device, blocks):
    """A cluster larger than n, through the library's entry point (the
    wrapper never asks for one): the blocks without a position still join
    the cluster's barriers and add nothing."""
    from mellow_tpu_torch.ops._build import check, load_library

    rng = np.random.RandomState(blocks)
    B, H, KV, hd, n = 2, 9, 3, 64, 7
    q = _bf16(rng, B, H, hd)
    k = _bf16(rng, B, n + 3, KV, hd)
    v = _bf16(rng, B, n + 3, KV, hd)
    out = torch.empty_like(q)
    check(load_library().mellow_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, B, H, KV, hd, n, k.stride(0),
        k.stride(1), blocks, torch.cuda.current_stream().cuda_stream), "decode attention kernel")
    torch.cuda.synchronize()
    _close_bf16(out, da.decode_attention_plain(q, k, v, n))


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
@pytest.mark.parametrize("n", [1, 389, 800])
def test_decode_attention_kernel_at_every_head_dim(device, n, hd):
    """Every head width the kernel is built for, at one, nine and sixteen
    blocks a cluster."""
    rng = np.random.RandomState(n + hd)
    B, H, KV = 2, 9, 3
    q = _bf16(rng, B, H, hd)
    k = _bf16(rng, B, n + 5, KV, hd)
    v = _bf16(rng, B, n + 5, KV, hd)
    before = da.LAUNCHES
    out = da.decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    _close_bf16(out, da.decode_attention_plain(q, k, v, n))


def _starts(B, n, kind):
    """(B,) int32 first positions: "ragged" gives rows 0 and n - 1 (its own
    position alone) and, past them, a start that empties the cluster's
    first blocks (2 * 48 + 5) and one in the last block; "zero" all 0."""
    if kind == "zero":
        return torch.zeros(B, dtype=torch.int32, device="cuda")
    pool = [0, n - 1, min(2 * da.POSITIONS_PER_BLOCK + 5, n - 1), max(n - 30, 0)]
    return torch.tensor([pool[b % len(pool)] for b in range(B)], dtype=torch.int32, device="cuda")


@pytest.mark.parametrize("kind", ["ragged", "zero"])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("n", [7, 389, 420])
def test_decode_attention_kernel_with_per_row_start(device, n, B, kind):
    """Row b attends to [start[b], n): ragged starts (0, n - 1, one that
    empties whole blocks of the cluster, one in its last block) against
    the plain version's mask; starts of 0 give the output without
    ``start`` bit for bit."""
    rng = np.random.RandomState(n + B)
    H, KV, hd = 9, 3, 64
    q = _bf16(rng, B, H, hd)
    k = _bf16(rng, 2, B, n + 8, KV, hd)[1]
    v = _bf16(rng, 2, B, n + 8, KV, hd)[1]
    start = _starts(B, n, kind)
    before = da.LAUNCHES
    out = da.decode_attention(q, k, v, n, start)
    torch.cuda.synchronize()
    assert da.LAUNCHES == before + 1
    _close_bf16(out, da.decode_attention_plain(q, k, v, n, start))
    if kind == "zero":
        assert torch.equal(out, da.decode_attention_cuda(q, k, v, n))
    elif B > 1:
        # Row 1 starts at n - 1: it attends to its own position alone.
        assert torch.equal(out[1], v[1, n - 1].repeat_interleave(H // KV, dim=0))


def test_decode_attention_kernel_rejects_a_bad_start(device):
    rng = np.random.RandomState(0)
    q = _bf16(rng, 2, 9, 64)
    k = _bf16(rng, 2, 20, 3, 64)
    for bad in (torch.zeros(2, dtype=torch.int64, device="cuda"), torch.zeros(3, dtype=torch.int32, device="cuda"),
                torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="start must be"):
            da.decode_attention_cuda(q, k, k, 10, bad)


# ---------------------------------------------------------------------------
# int8 kernels
# ---------------------------------------------------------------------------

def _close_kv(got, want):
    """(k8, v8, k_scale, v_scale) against the plain version's."""
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.int8 and g.shape == w.shape
        assert (g.int() - w.int()).abs().max().item() <= 1
    for g, w in zip(got[2:], want[2:]):
        torch.testing.assert_close(g, w, rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("B, n, E", [(1, 389, 1), (4, 420, 1), (2, 7, 1), (1, 389, 4), (4, 420, 8),
                                     (2, 7, 8)])
def test_int8_decode_attention_kernel_matches_plain_version(device, B, n, E):
    q, k8, v8, ks, vs, extra = _int8_decode_inputs(B, n, E)
    before = di.LAUNCHES
    out = di.decode_attention_int8(q, k8, v8, ks, vs, n, *extra)
    torch.cuda.synchronize()
    assert di.LAUNCHES == before + 1
    _close_bf16(out, di.decode_attention_int8_plain(q, k8, v8, ks, vs, n, *extra))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("E", [1, 8])
@pytest.mark.parametrize("n", [1, 7, 48, 49, 389, 420, 4096])
def test_int8_decode_attention_kernel_at_every_length(device, n, E, B):
    """The cluster split around its block edges (48 positions a block), at
    the v0 prefix lengths and at a long cache, with one extra row and a
    whole flush window of them."""
    q, k8, v8, ks, vs, extra = _int8_decode_inputs(B, n, E, s_max=n + 8)
    before = di.LAUNCHES
    out = di.decode_attention_int8(q, k8, v8, ks, vs, n, *extra)
    torch.cuda.synchronize()
    assert di.LAUNCHES == before + 1
    _close_bf16(out, di.decode_attention_int8_plain(q, k8, v8, ks, vs, n, *extra))


def _max_ulp(a, b):
    """The largest distance between two bf16 tensors in units in the last
    place (+0 and -0 coincide)."""
    def ordered(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs().max().item()


@pytest.mark.parametrize("E", [1, 8])
@pytest.mark.parametrize("B, n", [(2, 7), (1, 49), (4, 389), (1, 4096)])
def test_int8_decode_attention_kernel_across_cluster_sizes(device, B, n, E):
    """Clusters of 1, 8 and 16 blocks and the default give outputs within
    one bf16 ulp of each other (only the order of the fp32 sum of exp
    follows the split), blocks that hold no position included (n = 7 and
    49 over 8 or 16 blocks)."""
    q, k8, v8, ks, vs, extra = _int8_decode_inputs(B, n, E, s_max=n + 8)
    outs = [di.decode_attention_int8_cuda(q, k8, v8, ks, vs, n, *extra, blocks=b) for b in (None, 1, 8, 16)]
    torch.cuda.synchronize()
    assert max(_max_ulp(a, b) for a in outs for b in outs) <= 1
    _close_bf16(outs[1], di.decode_attention_int8_plain(q, k8, v8, ks, vs, n, *extra))


@pytest.mark.parametrize("kind", ["ragged", "zero"])
@pytest.mark.parametrize("E", [1, 8])
@pytest.mark.parametrize("B", [1, 4, 8])
@pytest.mark.parametrize("n", [7, 389, 420])
def test_int8_decode_attention_kernel_with_per_row_start(device, n, B, E, kind):
    """Row b attends to cached positions [start[b], n) and its E extra rows:
    ragged starts (0, n - 1, one that empties whole blocks of the cluster,
    one in its last block) against the plain version's mask; starts of 0
    give the output without ``start`` bit for bit; a start at n leaves a
    row its extra rows alone."""
    q, k8, v8, ks, vs, extra = _int8_decode_inputs(B, n, E, s_max=n + 8)
    start = _starts(B, n, kind)
    before = di.LAUNCHES
    out = di.decode_attention_int8(q, k8, v8, ks, vs, n, *extra, start)
    torch.cuda.synchronize()
    assert di.LAUNCHES == before + 1
    _close_bf16(out, di.decode_attention_int8_plain(q, k8, v8, ks, vs, n, *extra, start))
    if kind == "zero":
        assert torch.equal(out, di.decode_attention_int8_cuda(q, k8, v8, ks, vs, n, *extra))
    else:
        empty = torch.full((B,), n, dtype=torch.int32, device="cuda")
        alone = di.decode_attention_int8_cuda(q, k8, v8, ks, vs, n, *extra, empty)
        torch.cuda.synchronize()
        _close_bf16(alone, di.decode_attention_int8_plain(q, k8, v8, ks, vs, n, *extra, empty))


@pytest.mark.parametrize("E", [0, 9])
def test_int8_decode_attention_kernel_rejects_extra_counts(device, E):
    q, k8, v8, ks, vs, _ = _int8_decode_inputs(1, 9, 1)
    rng = np.random.RandomState(E)
    extra = (_bf16(rng, 1, 9, 3, 64)[:, :E], _bf16(rng, 1, 9, 3, 64)[:, :E])
    with pytest.raises(ValueError):
        di.decode_attention_int8_cuda(q, k8, v8, ks, vs, 9, *extra)


@pytest.mark.parametrize("B, S", [(1, 389), (2, 100)])
def test_attn_block_kv_quant_kernel_matches_plain_version(device, B, S):
    rng = np.random.RandomState(S + 3)
    D, H, KV, hd = 576, 9, 3, 64
    x = _bf16(rng, B, S, D, scale=0.5)
    ws = [_bf16(rng, D, scale=0.1) + 1, _bf16(rng, D, H * hd, scale=0.05),
          _bf16(rng, D, KV * hd, scale=0.05), _bf16(rng, D, KV * hd, scale=0.05),
          _bf16(rng, H * hd, D, scale=0.05)]
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=1e-5, kv_quant=True)
    cache = torch.zeros((2, B, S + 8, KV, hd), dtype=torch.int8, device="cuda")
    scales = torch.zeros((2, B, S + 8), dtype=torch.float32, device="cuda")
    before = ab.LAUNCHES_KV_QUANT
    out = ab.attn_block(x, *ws, *_rope(S, hd), **kw, k_out=cache[0, :, :S], v_out=cache[1, :, :S],
                        k_scale_out=scales[0, :, :S], v_scale_out=scales[1, :, :S])
    torch.cuda.synchronize()
    assert ab.LAUNCHES_KV_QUANT == before + 1
    ref = ab.attn_block_plain(x, *ws, *_rope(S, hd), **kw)
    _close_bf16(out[0], ref[0])
    _close_kv(out[1:], ref[1:])
    assert cache[:, :, S:].abs().sum().item() == 0 and scales[:, :, S:].abs().sum().item() == 0


@pytest.mark.parametrize("B, S, kv_quant", [(1, 389, True), (4, 389, True), (2, 13, False)])
def test_attn_block_w8a8_kernel_matches_plain_version(device, B, S, kv_quant):
    rng = np.random.RandomState(S + B)
    D, H, KV, hd = 576, 9, 3, 64
    x = _bf16(rng, B, S, D, scale=0.5)
    ln = _bf16(rng, D, scale=0.1) + 1
    ws = [t for shape in ((D, H * hd), (D, KV * hd), (D, KV * hd), (H * hd, D))
          for t in _int8(rng, *shape)]
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=1e-5, kv_quant=kv_quant)
    before = aw.LAUNCHES
    out = aw.attn_block_w8a8(x, ln, *ws, *_rope(S, hd), **kw)
    torch.cuda.synchronize()
    assert aw.LAUNCHES == before + 1
    ref = aw.attn_block_w8a8_plain(x, ln, *ws, *_rope(S, hd), **kw)
    _close_bf16(out[0], ref[0])
    if kv_quant:
        _close_kv(out[1:], ref[1:])
    else:
        for got, want in zip(out[1:], ref[1:]):
            _close_bf16(got, want)


BLOCK_SHAPES = [(B, S, H, KV) for H, KV in ((9, 3), (12, 12), (8, 2), (12, 4))
                for S in (1, 17, 63, 64, 65, 389, 1024) for B in (1, 4)]
# The attention core's upper edge, at B = 1: the plain version holds
# (B, H, S, S) fp32 scores several times over.
BLOCK_SHAPES += [(1, ab.MAX_S, H, KV) for H, KV in ((9, 3), (12, 12), (8, 2), (12, 4))]


def _block_case(kind, B, S, H, KV):
    """Seeded inputs of one attention-block call: (args, kwargs) of the
    CUDA wrapper and of the plain version, k/v going into a strided cache
    slice with 8 positions of room past S (int8 with its scales in
    ``kv_quant`` mode)."""
    rng = np.random.RandomState(S * 7 + B * 3 + H + KV)
    D, hd = 576, 64
    x = _bf16(rng, B, S, D, scale=0.5)
    if kind == "w8a8":
        ws = [_bf16(rng, D, scale=0.1) + 1] + [t for shape in ((D, H * hd), (D, KV * hd), (D, KV * hd),
                                                               (H * hd, D)) for t in _int8(rng, *shape)]
    else:
        ws = [_bf16(rng, D, scale=0.1) + 1, _bf16(rng, D, H * hd, scale=0.05), _bf16(rng, D, KV * hd, scale=0.05),
              _bf16(rng, D, KV * hd, scale=0.05), _bf16(rng, H * hd, D, scale=0.05)]
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd, eps=1e-5, kv_quant=kind != "bf16")
    dt = torch.bfloat16 if kind == "bf16" else torch.int8
    cache = torch.zeros((2, B, S + 8, KV, hd), dtype=dt, device="cuda")
    dst = dict(k_out=cache[0, :, :S], v_out=cache[1, :, :S])
    scales = torch.zeros((2, B, S + 8), dtype=torch.float32, device="cuda")
    if kind != "bf16":
        dst.update(k_scale_out=scales[0, :, :S], v_scale_out=scales[1, :, :S])
    return (x, *ws, *_rope(S, hd)), kw, dst, cache, scales


@pytest.mark.parametrize("kind", ["bf16", "kv_quant", "w8a8"])
@pytest.mark.parametrize("B, S, H, KV", BLOCK_SHAPES)
def test_attn_block_kernels_at_every_shape(device, kind, B, S, H, KV):
    """#4, #4 kv_quant and #5 (kv_quant) against their plain versions from
    one position to the attention core's cap, at four head geometries, k/v
    written into a cache slice with room past S."""
    args, kw, dst, cache, scales = _block_case(kind, B, S, H, KV)
    cuda, plain = ((aw.attn_block_w8a8_cuda, aw.attn_block_w8a8_plain) if kind == "w8a8"
                   else (ab.attn_block_cuda, ab.attn_block_plain))
    out = cuda(*args, **kw, **dst)
    torch.cuda.synchronize()
    ref = plain(*args, **kw)
    _close_bf16(out[0], ref[0])
    if kind == "bf16":
        for got, want in zip(out[1:], ref[1:]):
            _close_bf16(got, want)
    else:
        _close_kv(out[1:], ref[1:])
    assert cache[:, :, S:].abs().sum().item() == 0 and scales[:, :, S:].abs().sum().item() == 0


@pytest.mark.parametrize("kind", ["bf16", "w8a8"])
@pytest.mark.parametrize("S", [0, ab.MAX_S + 1])
def test_attn_block_kernels_refuse_past_their_edges(device, kind, S):
    args, kw, _, _, _ = _block_case(kind, 1, 1, 9, 3)
    x = torch.zeros((1, S, 576), dtype=torch.bfloat16, device="cuda")
    cos = torch.zeros((S, 64), dtype=torch.bfloat16, device="cuda")
    cuda = aw.attn_block_w8a8_cuda if kind == "w8a8" else ab.attn_block_cuda
    with pytest.raises(ValueError, match="unsupported geometry"):
        cuda(x, *args[1:-2], cos, cos, **kw)


@pytest.mark.parametrize("B, S", [(1, 389), (4, 389), (2, 13)])
def test_mlp_block_w8a8_kernel_matches_plain_version(device, B, S):
    rng = np.random.RandomState(S + B + 5)
    D, I = 576, 1536
    x = _bf16(rng, B, S, D, scale=0.5)
    ln = _bf16(rng, D, scale=0.1) + 1
    ws = [t for shape in ((D, I), (D, I), (I, D)) for t in _int8(rng, *shape)]
    before = mw.LAUNCHES
    out = mw.mlp_block_w8a8(x, ln, *ws, eps=1e-5)
    torch.cuda.synchronize()
    assert mw.LAUNCHES == before + 1
    _close_bf16(out, mw.mlp_block_w8a8_plain(x, ln, *ws, eps=1e-5))


@pytest.mark.parametrize("D, I", [(576, 1536), (64, 128), (768, 2048)])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [1, 13, 389])
def test_mlp_block_w8a8_kernel_at_every_shape(device, S, B, D, I):
    """Row blocks past M, fewer column tiles than the gate/up cluster has
    blocks (I = 128), more than 3 a block (I = 2048), and every K split of
    the down launch."""
    rng = np.random.RandomState(S * B + D)
    x = _bf16(rng, B, S, D, scale=0.5)
    ln = _bf16(rng, D, scale=0.1) + 1
    ws = [t for shape in ((D, I), (D, I), (I, D)) for t in _int8(rng, *shape)]
    out = mw.mlp_block_w8a8_cuda(x, ln, *ws, eps=1e-5)
    torch.cuda.synchronize()
    _close_bf16(out, mw.mlp_block_w8a8_plain(x, ln, *ws, eps=1e-5))


# ---------------------------------------------------------------------------
# prefill attention (#10)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B, S, H, KV, packed", [(1, 389, 12, 12, True), (4, 389, 12, 12, True),
                                                 (2, 100, 9, 3, False), (1, 13, 12, 12, True)])
def test_flash_gqa_prefill_kernel_matches_plain_version(device, B, S, H, KV, packed):
    """``packed``: q, k, v are the column slices of one qkv product, as the
    GPT-2 prefill hands them over; otherwise three contiguous tensors."""
    rng = np.random.RandomState(S + H)
    hd = 64
    if packed:
        q, k, v = _bf16(rng, B, S, (H + 2 * KV) * hd).split([H * hd, KV * hd, KV * hd], dim=-1)
    else:
        q, k, v = _bf16(rng, B, S, H * hd), _bf16(rng, B, S, KV * hd), _bf16(rng, B, S, KV * hd)
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd)
    before = fp.LAUNCHES
    out = fp.flash_gqa_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    _close_bf16(out, fp.flash_gqa_prefill_plain(q, k, v, **kw))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("S", [1, 17, 64, 65, 389, 1024, 4096])
def test_flash_gqa_prefill_kernel_at_every_length(device, S, B):
    """GPT-2's geometry (H = KV = 12) with q, k, v the column slices of one
    qkv product, around the 64-row tile edges and up to 4096 positions."""
    rng = np.random.RandomState(S + B)
    H, hd = 12, 64
    q, k, v = _bf16(rng, B, S, 3 * H * hd).split(H * hd, dim=-1)
    kw = dict(num_heads=H, num_kv_heads=H, head_dim=hd)
    before = fp.LAUNCHES
    out = fp.flash_gqa_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fp.LAUNCHES == before + 1
    _close_bf16(out, fp.flash_gqa_prefill_plain(q, k, v, **kw))


@pytest.mark.parametrize("B, S, H, KV", [(1, 389, 9, 3), (4, 130, 9, 3), (2, 389, 8, 2), (1, 200, 8, 1),
                                         (2, 77, 4, 2)])
def test_flash_gqa_prefill_kernel_shares_tiles_across_a_group(device, B, S, H, KV):
    """GQA: the query heads of a KV group share a block's K/V tiles (3, 4,
    4 of 8, and 2 heads per block)."""
    rng = np.random.RandomState(S + H + KV)
    hd = 64
    q, k, v = _bf16(rng, B, S, (H + 2 * KV) * hd).split([H * hd, KV * hd, KV * hd], dim=-1)
    kw = dict(num_heads=H, num_kv_heads=KV, head_dim=hd)
    out = fp.flash_gqa_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    _close_bf16(out, fp.flash_gqa_prefill_plain(q, k, v, **kw))


@pytest.mark.parametrize(
    "shape, cols, dtype, H",
    [((1, 389, 768), slice(None), torch.float32, 12),
     ((1, 389, 768), slice(None), torch.bfloat16, 24),  # hd = 32
     ((1, fp.MAX_SEQ + 8, 768), slice(None), torch.bfloat16, 12),  # S past the kernel's range
     ((1, 389, 776), slice(1, 769), torch.bfloat16, 12),  # a base off 16-byte alignment
     ((1, 389, 772), slice(0, 768), torch.bfloat16, 12)],  # a row stride not a multiple of 8
    ids=["float32", "head_dim", "long", "misaligned", "row_stride"],
)
def test_flash_gqa_prefill_kernel_rejects_what_it_does_not_take(device, shape, cols, dtype, H):
    rng = np.random.RandomState(3)
    q, k, v = (_bf16(rng, *shape).to(dtype)[..., cols] for _ in range(3))
    with pytest.raises(ValueError):
        fp.flash_gqa_prefill_cuda(q, k, v, num_heads=H, num_kv_heads=H, head_dim=768 // H)


# ---------------------------------------------------------------------------
# window attention (#9)
# ---------------------------------------------------------------------------

def _window_inputs(B, R, C, H, shift, device):
    """qkv of the B * (R/8)^2 windows of an R x R grid, the (H, 64, 64)
    bias and the grid's shifted-window mask (or None)."""
    from mellow_tpu_torch.models.htsat import shifted_window_mask

    rng = np.random.RandomState(R + C + B)
    qkv = _bf16(rng, B * (R // 8) ** 2, 64, 3 * C, scale=0.5)
    bias = _bf16(rng, H, 64, 64, scale=0.5).float()
    mask = torch.from_numpy(shifted_window_mask(R, 8, shift)).to(device) if shift else None
    return qkv, bias, mask


@pytest.mark.parametrize("B, R, C, H, shift", [
    (1, 32, 512, 8, 0), (1, 32, 512, 8, 4), (4, 32, 512, 8, 0), (4, 32, 512, 8, 4),  # HTSAT-large stage 2
    (2, 64, 96, 4, 4), (1, 32, 256, 8, 4), (1, 16, 384, 6, 0),  # hd = 24, 32, 64
    (1, 16, 384, 8, 4), (2, 16, 60, 3, 4),  # hd = 48; hd = 20, no 16-byte copies
])
def test_window_attention_kernel_matches_plain_version(device, B, R, C, H, shift):
    qkv, bias, mask = _window_inputs(B, R, C, H, shift, device)
    before = wa.LAUNCHES
    out = wa.window_attention(qkv, bias, mask, num_heads=H)
    torch.cuda.synchronize()
    assert wa.LAUNCHES == before + 1
    _close_bf16(out, wa.window_attention_plain(qkv, bias, mask, num_heads=H))


@pytest.mark.parametrize("Bn", [5, 20])
def test_window_attention_kernel_takes_bn_not_a_multiple_of_the_mask(device, Bn):
    """Window w takes mask[w % nW] where Bn is not a multiple of nW = 16."""
    qkv, bias, mask = _window_inputs(2, 32, 512, 8, 4, device)
    qkv = qkv[:Bn].contiguous()
    out = wa.window_attention_cuda(qkv, bias, mask, num_heads=8)
    torch.cuda.synchronize()
    _close_bf16(out, wa.window_attention_plain(qkv, bias, mask, num_heads=8))


@pytest.mark.parametrize("what", ["float32", "bias_shape", "strided", "cpu", "head_dim"])
def test_window_attention_kernel_rejects_what_it_does_not_take(device, what):
    qkv, bias, mask = _window_inputs(1, 32, 512, 8, 4, device)
    H = 8
    if what == "float32":
        qkv = qkv.float()
    elif what == "bias_shape":
        bias = bias[:, :32].contiguous()
    elif what == "strided":
        qkv = torch.cat([qkv, qkv], dim=-1)[..., ::2]
    elif what == "cpu":
        qkv, bias, mask = qkv.cpu(), bias.cpu(), mask.cpu()
    else:
        H = 4  # hd = 128
    with pytest.raises(ValueError):
        wa.window_attention_cuda(qkv, bias, mask, num_heads=H)


# ---------------------------------------------------------------------------
# outputs kept bit for bit
# ---------------------------------------------------------------------------

PREVIOUS_DIGESTS = {
    "int8_decode_e1_b1": "ba5ea95714dd421c",
    "int8_decode_e1_b4": "254b82997ed3bc13",
    "attn_block": "eff42a2eef1565ae",
    "attn_block_kv_quant": "0582beb5d9d8bbe6",
    "attn_block_w8a8": "072e3e92f10831c8",
    "attn_block_w8a8_kv": "e7cbee64d643f5e7",
    "mlp_block": "df660ccdbb6b308b",
    "mlp_block_w8a8_b1": "31cf8d1bf8aaf371",
    "mlp_block_w8a8_b4": "5e13ba6b5d25d04c",
    "swin_block_s1": "f69ae46ef28529ee",
    "swin_block_s2": "df76477670e8ffca",
    "swin_block_s3": "387c4639b892177a",
    "window_attention": "f29505f902725520",
    "window_attention_hd24": "4cf044a161ad50b2",
}


@pytest.mark.parametrize("name", list(PREVIOUS_DIGESTS))
def test_kernels_keep_their_previous_output(device, name):
    out = _digest_case(name)
    torch.cuda.synchronize()
    got = _digest(*out)
    print(f"{name}: {got}")
    assert got == PREVIOUS_DIGESTS[name]
