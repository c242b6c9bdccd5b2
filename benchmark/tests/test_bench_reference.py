"""The plain reference against the port's CPU path at tiny sizes, in
float32: the ViT's static, 2D-masked and hybrid forwards (draws from the
same seed), its gradients, and the MAE's loss and gradients with the swin
decoder.  The port runs its kernels' plain versions on the CPU."""

import pytest
import torch

from benchmark.lib import seeds
from benchmark.reference import mae as ref_mae
from benchmark.reference import precision
from benchmark.reference import vit as ref_vit

VIT = dict(embed_dim=64, depth=4, num_heads=2, mlp_ratio=4.0, patch_size=16,
           in_chans=1, target_length=128, num_mel_bins=64, num_classes=10,
           drop_loc=[1, 2], base_keep_rate=0.7, drop_path_rate=0.1,
           compute_dtype="float32")
MAE = dict(embed_dim=64, depth=2, num_heads=2, decoder_embed_dim=64,
           decoder_depth=2, decoder_num_heads=2, decoder_mode=1,
           window_size=[4, 4], mlp_ratio=4.0, patch_size=16,
           target_length=128, num_mel_bins=64, norm_pix_loss=True,
           mask_2d=True, mask_t_prob=0.5, mask_f_prob=0.3,
           compute_dtype="float32")
B = 3


def _vit():
    from tpat_tpu_torch.config import ViTConfig
    from tpat_tpu_torch.models.vit import AudioViT

    cfg = ViTConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in VIT.items()})
    w = seeds.weights(ref_vit.param_specs(VIT), 11, "cpu")
    model = AudioViT(cfg)
    model.load_state_dict(w, strict=True)
    return cfg, model, {n: t.clone().requires_grad_(n not in ref_vit.FROZEN)
                        for n, t in w.items()}


def _x(shape, seed=5):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _program(cfg, model, step, x, gen):
    from tpat_tpu_torch.config import compose_kept_counts
    from tpat_tpu_torch.engine import schedules

    depth = cfg.depth
    if step["kind"] == "static":
        return model(x, tuple(step["keep"]), generator=gen)
    if step["kind"] == "dense":
        p = step["mask_prob"]
        return model(x, (1.0,) * depth, mask_t_prob=p, mask_f_prob=p,
                     generator=gen)
    rates = tuple(step["rate"] if i in cfg.drop_loc else 1.0
                  for i in range(depth))
    assert compose_kept_counts  # the hybrid's widths come from the schedules
    return model.forward_hybrid(
        x, rates, num_left=schedules.masked_kept_counts(rates, cfg.drop_loc,
                                                        cfg.num_patches),
        bucket_rates=schedules.bucket_keep_rates(rates, base_keep_rate=0.7),
        generator=gen)


STEPS = [{"kind": "static", "keep": [1.0, 0.7, 0.7, 1.0]},
         {"kind": "dense", "mask_prob": 0.3},
         {"kind": "hybrid", "rate": 0.75},
         {"kind": "hybrid", "rate": 0.95}]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("step", STEPS, ids=lambda s: s["kind"] + str(
    s.get("rate", "")))
def test_vit_reference_matches_the_port(step, train):
    cfg, model, P = _vit()
    model.train(train)
    x = _x((B, 1, 128, 64))
    y = torch.nn.functional.one_hot(torch.arange(B) % 10, 10).float()
    got = _program(cfg, model, step, x, torch.Generator().manual_seed(3))
    draw = ref_vit.draws(VIT, step, B, torch.Generator().manual_seed(3),
                         "cpu", train=train)
    want = ref_vit.forward(P, VIT, step, x, draw, precision.F32)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)
    if not train:
        return
    from tpat_tpu_torch.engine.train import soft_cross_entropy

    soft_cross_entropy(got, y).backward()
    (ref_vit.soft_ce_sum(want, y) / B).backward()
    for name, p in model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.grad, P[name].grad, atol=1e-6,
                                       rtol=1e-4, msg=name)


def test_mae_reference_matches_the_port():
    from tpat_tpu_torch.models.mae import MAEConfig, MaskedAutoencoderViT

    cfg = MAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in MAE.items()})
    w = seeds.weights(ref_mae.param_specs(MAE), 13, "cpu")
    model = MaskedAutoencoderViT(cfg)
    model.load_state_dict(w, strict=True)
    model.train()
    P = {n: t.clone().requires_grad_(n not in ref_mae.FROZEN)
         for n, t in w.items()}
    x = _x((B, 1, 128, 64))
    loss, _, mask = model(x, generator=torch.Generator().manual_seed(9),
                          deterministic=False)
    draw = ref_mae.draws(MAE, B, torch.Generator().manual_seed(9), "cpu",
                         train=True)
    part, count = ref_mae.loss_sum(P, MAE, x, draw, precision.F32)
    assert float(count) == float(mask.sum())
    torch.testing.assert_close(loss, part / count, atol=1e-6, rtol=1e-5)
    loss.backward()
    (part / count).backward()
    for name, p in model.named_parameters():
        if p.requires_grad:
            torch.testing.assert_close(p.grad, P[name].grad, atol=1e-7,
                                       rtol=1e-4, msg=name)


def test_the_control_is_fp8_products():
    a, b = _x((4, 8), 1), _x((8, 3), 2)
    exact = a @ b
    ctl = precision.FP8.matmul(a, b)
    err = (ctl - exact).abs().max() / exact.abs().max()
    assert 1e-3 < float(err) < 0.2
    assert torch.equal(precision.F32.matmul(a, b), exact)
