"""The frozen work counts and the step geometry against hand counts."""

import pytest

from benchmark.lib import frozen, work

VIT = dict(embed_dim=768, depth=12, num_heads=12, mlp_ratio=4.0, patch_size=16,
           in_chans=1, target_length=512, num_mel_bins=128, num_classes=50,
           drop_loc=[3, 6, 9], base_keep_rate=0.7)
MAE = dict(embed_dim=768, depth=12, num_heads=12, decoder_embed_dim=512,
           decoder_depth=16, decoder_num_heads=16, window_size=[4, 4],
           patch_size=16, target_length=1024, num_mel_bins=128, mask_2d=True,
           mask_t_prob=0.7, mask_f_prob=0.3)
STATIC = {"kind": "static", "keep": [0.7 if i in (3, 6, 9) else 1.0
                                     for i in range(12)]}


def test_qkv_work_by_hand():
    # B 2, N 10, C 6 (H 2, D 3), kv 8, bf16, scores 'patch_mean', extra 1
    nbytes, flops, exps = frozen.qkv_work(2, 10, 18, 2, 2, mode="patch_mean",
                                          kv=8)
    assert nbytes == 2 * 2 * (10 * 6 + 2 * 8 * 6 + 10 * 6) + 4 * 2 * 9
    assert flops == 4 * 2 * 2 * 10 * 8 * 3 and exps == 2 * 2 * 10 * 8
    nbytes, flops, _ = frozen.qkv_work(2, 10, 18, 2, 2, kv=8, bwd=True)
    assert nbytes == 2 * 2 * (10 * 6 + 2 * 8 * 6 + 10 * 6 + 10 * 18)
    assert flops == 10 * 2 * 2 * 10 * 8 * 3


def test_window_work_by_hand():
    import torch

    t = torch.full((2, 8, 8), -1e30)
    t[:, :4, :4] = 0.0  # 16 live pairs a head
    qkv = torch.zeros(3, 8, 12, dtype=torch.bfloat16)
    nb, fl, ex = frozen.window_work(qkv, t, banded=False, bwd=False)
    assert nb == 2 * 3 * 8 * (12 + 4) + 2 * 8 * 8 * 4 + 4 * 2
    assert fl == 4 * 3 * 32 * 2 and ex == 3 * 32
    assert frozen.window_work_shapes(3, 8, 12, 2, 2, 128, 32, True) == \
        frozen.window_work(qkv, t, banded=False, bwd=True)


def test_bound_ms_picks_the_larger_term():
    ms, by = frozen.bound_ms(3.35e12, 0.0, "bfloat16")
    assert ms == pytest.approx(1e3) and by == "bytes"
    ms, by = frozen.bound_ms(0.0, 989e12 * 2, "bfloat16")
    assert ms == pytest.approx(2e3) and by == "operations"
    ms, by = frozen.bound_ms(0.0, 0.0, "bfloat16", exps=frozen.exp_rate(1e9),
                             sm_clock_hz=1e9)
    assert ms == pytest.approx(1e3)


def test_static_geometry_is_the_papers_walk():
    blocks = work.vit_block_geometry(VIT, STATIC)
    assert [b["n"] for b in blocks] == [257] * 4 + [181] * 3 + [127] * 3 + [90] * 2
    assert [b["mlp"] for b in blocks][3::3] == [181, 127, 90]
    assert [b["scores"] for b in blocks].count(True) == 3


def test_dense_masked_and_hybrid_geometry():
    dense = work.vit_block_geometry(VIT, {"kind": "dense", "mask_prob": 0.3})
    assert {b["n"] for b in dense} == {111}  # 1 + 22 * 5
    hyb = work.vit_block_geometry(VIT, {"kind": "hybrid", "rate": 0.75})
    # bucket 0.8: widths 205, 164, 132; scheduled 0.75: 192, 144, 108
    assert [b["n"] for b in hyb] == [257] * 4 + [206] * 3 + [165] * 3 + [133] * 2
    assert [b["kv"] for b in hyb] == [257] * 4 + [193] * 3 + [145] * 3 + [109] * 2


def test_vit_flops_by_hand():
    m = dict(VIT, depth=1, drop_loc=[])
    f = work.vit_forward_flops(m, {"kind": "static", "keep": [1.0]}, 2)
    n, c = 257, 768
    one = (2 * 256 * 256 * c + 2 * n * c * 3 * c + 4 * n * n * c
           + 2 * n * c * c + 4 * n * c * 3072 + 2 * c * 50)
    assert f == 2 * one


def test_mae_geometry_and_flops():
    g = work.mae_geometry(MAE)
    assert g["enc"] == 1 + 19 * 5 and g["dec"] == 512 and g["window"] == 16
    f = work.mae_forward_flops(MAE, 1)
    assert 60e9 < f < 80e9  # about 70 GFLOP a clip forward
    calls = work.mae_window_calls(MAE, 256)
    assert len(calls) == 32 and calls[0]["template_numel"] == 16 * 512 * 128
    assert calls[0]["pairs"] == 16 * 512 * 16


def test_attention_calls_count_a_backward_per_forward():
    calls = work.vit_attention_calls(VIT, STATIC, 128, backward=True)
    assert len(calls) == 24 and sum(c["bwd"] for c in calls) == 12
