"""The port's AudioViT (tpat_tpu_torch.models.vit) against the JAX AudioViT.

Same weights (JAX params set from numpy with sharpened qkv, carried across by
``state_dict_from_jax``) and the same numpy inputs go through both.  The JAX
model runs attention_impl='fused' (C = 256 is a multiple of 128, so its
Pallas kernel runs, in interpret mode); the port on the CPU runs its plain
kernel version."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import ViTConfig
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu_torch.config import audiomae_vit_base
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.utils.weights import state_dict_from_jax

EMBED, HEADS, DEPTH, NC = 256, 4, 4, 10


def _cfg(dtype="float32", keep=0.7):
    return ViTConfig(
        compute_dtype=dtype, embed_dim=EMBED, depth=DEPTH, num_heads=HEADS,
        num_classes=NC, target_length=128, num_mel_bins=128,
        drop_loc=(1, 2), base_keep_rate=keep, drop_path_rate=0.0,
    )


def _sharpened_params(cfg, seed=0):
    """JAX params with every leaf N(0, 0.05^2) except qkv, N(0, 1): sharp
    attention separates the importance scores, so top-k is well
    conditioned across frameworks (as test_model_parity does)."""
    model = JaxAudioViT(cfg)
    init = model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 1, 128, 128))
    )["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        scale = 1.0 if "qkv" in name else 0.05
        return (rng.normal(size=np.shape(leaf)) * scale).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(draw, init)


def _port(cfg, params):
    model = AudioViT(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def pair():
    jmodel, params = _sharpened_params(_cfg())
    x = np.random.default_rng(1).normal(size=(3, 1, 128, 128)).astype(np.float32)
    return jmodel, params, x


@pytest.mark.parametrize("keep", [1.0, 0.7, 0.5])
def test_audiomae_static_forward_matches_jax(pair, keep):
    """f32: logits rtol 1e-3 / atol 2e-4, scores rtol 1e-3, top-k indices
    exactly equal (the tolerances of test_audiomae_flavor_parity)."""
    jmodel, params, x = pair
    cfg = _cfg(keep=keep)
    want, wfeats = jmodel.apply(
        {"params": params}, jnp.asarray(x), cfg.keep_rates, extract_features=True
    )
    with torch.no_grad():
        got, feats = _port(cfg, params)(torch.from_numpy(x), extract_features=True)
    assert got.dtype == torch.float32 and got.shape == (3, NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-4)
    assert set(feats) == set(wfeats)
    for k, v in wfeats.items():
        if k.endswith("topk_idx"):
            np.testing.assert_array_equal(feats[k].numpy(), np.asarray(v))
        elif k.endswith("attn_score"):
            np.testing.assert_allclose(
                feats[k].numpy(), np.asarray(v), rtol=1e-3, atol=1e-6
            )
    if keep < 1.0:
        assert feats["block-1.topk_idx"].shape[1] == cfg.tokens_per_block()[1][1]
    assert qa.launches == 0


def test_bf16_forward_matches_jax_at_keep_1(pair):
    """bf16 compute, no pruning: parameters and rounding points match, but
    bf16 matmuls on two backends round differently; logits within 5% of
    the largest |logit| (they are ~1e-1, differences ~1e-3)."""
    _, params, x = pair
    cfg = _cfg(dtype="bfloat16", keep=1.0)
    want = JaxAudioViT(cfg).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port(cfg, params)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 0.05 * np.abs(want).max()


def test_state_dict_keys_are_the_reference_pth_keys(pair):
    _, params, _ = pair
    model = AudioViT(_cfg())
    assert set(model.state_dict()) == set(state_dict_from_jax(params))
    assert "blocks.3.attn.qkv.weight" in model.state_dict()
    assert not model.pos_embed.requires_grad  # frozen sin-cos table


def test_vit_b_esc50_token_walk_on_cpu():
    """Full-width ViT-B/16 at ESC-50 geometry, keep 0.7 at (3, 6, 9): the
    pruned widths are 256 -> 180 -> 126 -> 89 patch tokens."""
    cfg = audiomae_vit_base(
        target_length=512, num_classes=50, base_keep_rate=0.7,
        drop_loc=(3, 6, 9), drop_path_rate=0.0, compute_dtype="float32",
    )
    model = AudioViT(cfg, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(
        np.random.default_rng(0).normal(size=(1, 1, 512, 128)).astype(np.float32)
    )
    with torch.no_grad():
        logits, feats = model(x, extract_features=True)
    assert logits.shape == (1, 50) and torch.isfinite(logits).all()
    assert [feats[f"block-{i}.topk_idx"].shape[1] for i in (3, 6, 9)] == [180, 126, 89]
    assert feats["block-10.attn_score"].shape == (1, 89)


def test_unported_features_refuse():
    cfg = _cfg()
    model = AudioViT(cfg).eval()
    x = torch.zeros(1, 1, 128, 128)
    with pytest.raises(NotImplementedError):
        model(x, custom_rank="mean")
    # 2D masking and drop-path are ported; in training they draw from an
    # explicit generator and refuse to run without one
    with pytest.raises(ValueError, match="2D masking"):
        model(x, mask_t_prob=0.2, mask_f_prob=0.2)
    with pytest.raises(ValueError, match="drop-path"):
        AudioViT(dataclasses.replace(cfg, drop_path_rate=0.1))(x)
    with pytest.raises(NotImplementedError, match="dropout"):
        AudioViT(dataclasses.replace(cfg, drop_rate=0.1))(x)
    from tpat_tpu.config import ast_vit_base

    with pytest.raises(NotImplementedError, match="AST"):
        AudioViT(ast_vit_base(target_length=32, num_classes=2))
    with pytest.raises(ValueError, match="keep_rates"):
        model(x, (1.0,))


def test_dense_init_xavier_uniform_matches_the_jax_init():
    """ViTConfig.dense_init (as tests/test_mae.py checks the JAX init):
    under 'xavier_uniform' every trunk Linear weight lies within
    +-sqrt(6/(fan_in+fan_out)) and reaches near that bound, the patch conv
    likewise over its (O, I*kh*kw)-flattened fans; the default
    'trunc_normal' stays within +-2 std = 0.04; the head is
    trunc-normal(2e-5) under both."""
    from torch import nn

    def bound(w):
        return float(np.sqrt(6.0 / (w[0].numel() + w.shape[0])))

    model = AudioViT(dataclasses.replace(_cfg(), dense_init="xavier_uniform"))
    linears = [(n, m.weight) for n, m in model.named_modules()
               if isinstance(m, nn.Linear) and n != "head"]
    assert len(linears) == 4 * DEPTH  # qkv, proj, fc1, fc2 per block
    conv = model.patch_embed.proj.weight
    assert conv.dim() == 4
    for name, w in linears + [("patch conv", conv)]:
        peak = w.abs().max().item()
        assert peak <= bound(w) * 1.0001, name
        assert peak >= bound(w) * 0.9, (name, "not uniform to the bound")
    assert model.head.weight.abs().max().item() <= 4e-5
    default = AudioViT(_cfg())
    for name, m in default.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) and name != "head":
            assert m.weight.abs().max().item() <= 0.04 * 1.0001, name
    assert default.head.weight.abs().max().item() <= 4e-5
