"""The benchmark's operation and byte counts against values worked out by
hand at small shapes, and its bound of least time."""

import pytest

from port_bench import counts, peaks

DEC = {"hidden_size": 8, "intermediate_size": 16, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
       "num_layers": 1, "vocab_size": 10}


def test_swin_block_flops():
    # qkv 2*64*8*24 = 24576, proj 8192, fc1 and fc2 32768 each; four
    # windows of 16: q k^T and p v 2*16*16*8 = 4096 each a window.
    assert counts.swin_block_flops(64, 8, 16) == 24576 + 8192 + 2 * 32768 + 2 * 4 * 4096


def test_swin_block_bytes():
    # in and out 2*2*64*8 bf16; weights (216 + 72 + 288 + 264 + 32) bf16;
    # fp32 bias 2*16*16 and, shifted, the mask of 4 windows 4*16*16.
    assert counts.swin_block_bytes(2, 64, 8, 2, 16, shifted=True) == 4096 + 1744 + 2048 + 4096
    assert counts.swin_block_bytes(2, 64, 8, 2, 16, shifted=False) == 4096 + 1744 + 2048


def test_prefill_blocks():
    # q 2*3*8*8, k and v 2*3*8*4 each, o 2*3*8*8; causal pairs 3*4/2 = 6,
    # q k^T and p v 2*4*6 each a head, two heads.
    assert counts.attn_block_flops(DEC, 1, 3) == 384 + 192 + 192 + 384 + 2 * 2 * 48
    assert counts.mlp_block_flops(DEC, 1, 3) == 3 * 2 * 3 * 8 * 16
    # x in and out 2*3*8, k and v 2*3*4, rope 2*3*4, weights 128 + 64 + 8.
    assert counts.attn_block_bytes(DEC, 1, 3) == (48 + 24 + 24 + 200) * 2
    assert counts.mlp_block_bytes(DEC, 1, 3) == (48 + 3 * 128 + 8) * 2


def test_decode_step_and_logits():
    # projections 256 + 128, MLP 768, attention over 5 positions 4*2*4*5.
    assert counts.decode_step_flops(DEC, 1, 5) == 256 + 128 + 768 + 160
    assert counts.logits_flops(DEC, 3) == 2 * 3 * 8 * 10


def test_v0_prefill_and_call():
    import json
    import os

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "v0_bf16.json")) as f:
        cfg = json.load(f)
    dec = cfg["decoder"]
    # 30 layers of 389 tokens: q/k/v/o 688,324,608, MLP 2,064,973,824 and
    # the causal attention 174,769,920 a layer.
    per_layer = 430202880 + 258121728 + 2064973824 + 174769920
    prefill = dec["num_layers"] * (counts.attn_block_flops(dec, 1, 389) + counts.mlp_block_flops(dec, 1, 389))
    assert prefill == 30 * per_layer == 87842050560
    enc = counts.encoder_flops(cfg)
    # HTSAT-tiny's 12 Swin blocks: 2.013 + 1.913 + 5.587 + 1.837 GFLOP by
    # stage; the front-end as an FFT 0.03 GFLOP, not a DFT product's 2.1.
    blocks = sum(d * counts.swin_block_flops(L, C, N) for d, (L, C, _, N, _) in
                 zip(cfg["encoder"]["depths"], counts.stage_shapes(cfg["encoder"])))
    assert blocks == 2013265920 + 1912602624 + 5586812928 + 1837105152
    assert 0.02e9 < counts.frontend_flops(cfg["frontend"], cfg["encoder"]) < 0.04e9
    assert blocks < enc < blocks + 1e9
    call = counts.call_flops(cfg, 128, 4)
    decode = sum(counts.decode_step_flops(dec, 128, 389 + i + 1) for i in range(3))
    assert call == pytest.approx(256 * enc + 128 * prefill + 4 * counts.logits_flops(dec, 128) + decode)


def test_stage_shapes_and_peaks():
    enc = {"spec_size": 256, "patch_stride": 4, "embed_dim": 96, "num_heads": [4, 8, 16, 32], "window_size": 8,
           "depths": [2, 2, 6, 2], "mlp_ratio": 4.0}
    shapes = counts.stage_shapes(enc)
    assert shapes[0] == (4096, 96, 4, 64, 64) and shapes[3] == (64, 768, 32, 64, 8)
    # A stage-1 block over one clip is bound by its operations.
    one = peaks.least_seconds(counts.swin_block_flops(4096, 96, 64), counts.swin_block_bytes(1, 4096, 96, 4, 64, True))
    assert one == pytest.approx(counts.swin_block_flops(4096, 96, 64) / peaks.BF16_FLOPS)
    assert peaks.least_seconds(0, 3.35e12) == 1.0 and peaks.least_seconds(989e12, 0) == 1.0
