"""The port's MAE (tpat_tpu_torch.models.mae) against the JAX package's
(tpat_tpu.models.mae), on the CPU, in f32.

Weights come from the JAX model's ``init`` and cross through the reference
``.pth`` layout (``utils/weights.py``); inputs are made with numpy from a
seed, and the port is handed the JAX masking noise.  The port's window
kernels run their plain versions on CPU tensors; the JAX side runs its
Pallas kernels in interpret mode, as tests/test_window_attention.py and
tests/test_mae.py do."""

import dataclasses

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

from tpat_tpu.models import mae as jmae
from tpat_tpu_torch.config import ViTConfig
from tpat_tpu_torch.models import mae
from tpat_tpu_torch.utils import weights

SMALL = dict(
    embed_dim=96, depth=2, num_heads=3, decoder_embed_dim=128,
    decoder_depth=2, decoder_num_heads=4, decoder_mode=1, num_mel_bins=128,
    window_size=(4, 4), compute_dtype="float32",
)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _assert_grads_match(port_named, jax_tree, rtol=1e-3, atol=5e-4):
    """Parameter gradients, entry by entry at test_window_attention's
    tolerances, except d(meta_fc2.bias): the sum of d(template), zero in
    exact arithmetic, so both sides hold only cancellation noise, which is
    compared by size (test_window_attention.py:61-68)."""
    got = weights.jax_flat_grads(port_named)
    want = _flat(jax_tree)
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        if k.endswith("meta_fc2/bias"):
            assert np.abs(w).max() < 5e-3 and np.abs(got[k]).max() < 5e-3, k
            continue
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


# --------------------------------------------------------------------------
# SwinBlock
# --------------------------------------------------------------------------

BLOCK_CASES = [  # (impl, feat, shift, dim, heads, batch)
    ("xla", (8, 8), (2, 0), 128, 4, 2),
    ("fused", (8, 8), (0, 0), 128, 4, 2),
    ("fused", (8, 8), (2, 0), 128, 4, 2),
    ("fused", (8, 8), (2, 2), 256, 8, 16),
    ("banded", (16, 8), (0, 0), 128, 4, 2),
    ("banded", (16, 8), (2, 0), 128, 4, 2),
]


def _blocks(impl, feat, shift, dim, heads):
    jblk = jmae.SwinBlock(dim=dim, num_heads=heads, feat_size=feat,
                          window=(4, 4), shift=shift, mlp_ratio=2.0,
                          attn_impl=impl)
    dec = ViTConfig(embed_dim=dim, num_heads=heads, mlp_ratio=2.0,
                    compute_dtype="float32")
    pblk = mae.SwinBlock(dec, feat, (4, 4), shift, impl)
    return jblk, pblk


def _block_weights(jparams, pblk):
    sd = {}
    weights._swin_v2_cr_block(sd, "b", jparams)
    pblk.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}, strict=True)


@pytest.mark.parametrize("impl,feat,shift,dim,heads,batch", BLOCK_CASES)
def test_swin_block_forward_and_gradients_match_jax(impl, feat, shift, dim,
                                                    heads, batch):
    """Output atol 1e-5; input and parameter gradients of sum(out^2) at
    rtol 1e-3 / atol 5e-4 (d(input) rtol/atol 1e-4), with random logit
    scales so d(scale) differs per head."""
    rng = np.random.default_rng(0)
    n = feat[0] * feat[1]
    x = rng.normal(size=(batch, n, dim)).astype(np.float32)
    jblk, pblk = _blocks(impl, feat, shift, dim, heads)
    params = jblk.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    params["attn"]["logit_scale"] = jnp.asarray(
        rng.normal(size=(heads,)).astype(np.float32))
    _block_weights(params, pblk)
    assert pblk.impl == impl

    def jloss(p, xx):
        return jnp.sum(jblk.apply({"params": p}, xx) ** 2)

    jout = jblk.apply({"params": params}, jnp.asarray(x))
    gp, gx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_()
    out = pblk(xt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    names = [k for k, _ in pblk.named_parameters()]
    grads = torch.autograd.grad((out ** 2).sum(),
                                [p for _, p in pblk.named_parameters()] + [xt])
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-4)
    _assert_grads_match(dict(zip(names, grads[:-1])), gp)


AUTO_CASES = [  # (dtype, tokens, want, heads)
    ("float32", 256, "fused", 16), ("bfloat16", 256, "fused", 16),
    ("bfloat16", 512, "banded", 16), ("float32", 512, "banded", 16),
    ("bfloat16", 448, "fused", 16), ("float32", 448, "xla", 16),
    ("bfloat16", 256, "xla", 8), ("bfloat16", 512, "xla", 8),
]


@pytest.mark.parametrize(
    "dtype,tokens,want,heads", AUTO_CASES,
    ids=["-".join(map(str, c[:3])) + ("" if c[3] == 16 else f"-heads{c[3]}")
         for c in AUTO_CASES])
def test_auto_picks_the_jax_formulation(dtype, tokens, want, heads):
    """The reference decoder (dim 512, 16 heads): 'auto' resolves as the
    JAX package's supports / supports_banded do.  At 8 heads (head_dim 64,
    which the JAX criterion admits but the port's kernels are not built
    for) it resolves to 'xla'."""
    dec = ViTConfig(embed_dim=512, num_heads=heads, compute_dtype=dtype)
    blk = mae.SwinBlock(dec, (tokens // 8, 8), (4, 4), (2, 0), "auto")
    assert blk.impl == want


@pytest.mark.parametrize("shift", [(0, 0), (2, 0)])
def test_auto_at_head_dim_64_matches_jax(shift):
    """A block at head_dim 64 built with 'auto': the port resolves to 'xla'
    (no kernel at that head_dim), the JAX block to its fused kernel; the
    outputs agree within the file's f32 forward tolerance."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 64, 128)).astype(np.float32)
    jblk, pblk = _blocks("auto", (8, 8), shift, 128, 2)
    assert pblk.impl == "xla"
    params = jblk.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))["params"]
    params["attn"]["logit_scale"] = jnp.asarray(
        rng.normal(size=(2,)).astype(np.float32))
    _block_weights(params, pblk)
    jout = jblk.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = pblk(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------


def _models(impl, target_length, **over):
    kw = dict(SMALL, target_length=target_length, **over)
    jcfg = jmae.MAEConfig(window_attention_impl=impl, **kw)
    pcfg = mae.MAEConfig(window_attention_impl=impl, **kw)
    jm = jmae.MaskedAutoencoderViT(jcfg)
    x = np.random.default_rng(1).normal(
        size=(2, 1, target_length, 128)).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "masking": jax.random.PRNGKey(1)},
                     jnp.asarray(x), 0.75)["params"]
    pm = mae.MaskedAutoencoderViT(pcfg)
    pm.load_state_dict(weights.mae_state_dict_from_jax(params), strict=True)
    return jm, params, pm, x


def _jax_noise(key, b, cfg, mask_2d):
    """The noise the JAX model draws from ``rng=key``
    (``mae.py:489,506-511``)."""
    if mask_2d:
        kt, kf = jax.random.split(key)
        t, f = cfg.grid
        return (torch.from_numpy(np.array(jax.random.uniform(kt, (b, t)))),
                torch.from_numpy(np.array(jax.random.uniform(kf, (b, f)))))
    return torch.from_numpy(np.array(
        jax.random.uniform(key, (b, cfg.num_patches))))


@pytest.mark.parametrize("impl,target_length", [
    ("xla", 128), ("fused", 128), ("auto", 128),
    ("xla", 256), ("banded", 256),
])
@pytest.mark.parametrize("mask_2d", [False, True])
def test_mae_forward_matches_jax(impl, target_length, mask_2d):
    """Loss rtol 1e-5, pred rtol 1e-4 / atol 1e-5 and the mask equal, the
    port against the JAX model at the same decoder impl, with JAX's masking
    noise (test_mae_model_fused_matches_xla geometry)."""
    jm, params, pm, x = _models(impl, target_length)
    key = jax.random.PRNGKey(7)
    jloss, jpred, jmask = jm.apply({"params": params}, jnp.asarray(x), 0.75,
                                   rng=key, mask_2d=mask_2d)
    noise = _jax_noise(key, 2, pm.cfg, mask_2d)
    with torch.no_grad():
        loss, pred, m = pm(torch.from_numpy(x), 0.75, mask_2d=mask_2d,
                           noise=noise)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-4,
                               atol=1e-5)


def test_norm_pix_loss_matches_jax():
    jm, params, pm, x = _models("fused", 128, norm_pix_loss=True)
    key = jax.random.PRNGKey(3)
    jloss, _, _ = jm.apply({"params": params}, jnp.asarray(x), 0.8, rng=key)
    with torch.no_grad():
        loss, _, _ = pm(torch.from_numpy(x), 0.8,
                        noise=_jax_noise(key, 2, pm.cfg, False))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)


@pytest.mark.parametrize("mask_2d", [False, True])
def test_masking_ids_match_jax(mask_2d):
    """x_masked, mask and ids_restore of both masking flavours equal JAX's
    for the same noise (the 2D flavour through the max(999, t*f) offset)."""
    jm, params, pm, _ = _models("xla", 256)
    cfg = pm.cfg
    x = np.random.default_rng(2).normal(size=(3, cfg.num_patches, 5)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    if mask_2d:
        want = jm.apply({"params": params}, jnp.asarray(x), 0.5, 0.5, key,
                        method=jmae.MaskedAutoencoderViT.random_masking_2d)
        got = pm.random_masking_2d(torch.from_numpy(x), 0.5, 0.5,
                                   _jax_noise(key, 3, cfg, True))
    else:
        want = jm.apply({"params": params}, jnp.asarray(x), 0.8, key,
                        method=jmae.MaskedAutoencoderViT.random_masking)
        got = pm.random_masking(torch.from_numpy(x), 0.8,
                                _jax_noise(key, 3, cfg, False))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_patchify_roundtrip_matches_jax():
    jm, params, pm, _ = _models("xla", 128)
    imgs = np.random.default_rng(3).normal(size=(2, 1, 128, 128)).astype(np.float32)
    x = pm.patchify(torch.from_numpy(imgs))
    jx = jm.apply({"params": params}, jnp.asarray(imgs),
                  method=jmae.MaskedAutoencoderViT.patchify)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    assert torch.equal(pm.unpatchify(x), torch.from_numpy(imgs))


def test_init_matches_jax_layout():
    """Same parameter names and shapes as the JAX init exported to the
    reference layout; the fixed pos tables and logit scales equal JAX's;
    the xavier bounds hold."""
    jm, params, _, _ = _models("xla", 128)
    pm = mae.MaskedAutoencoderViT(
        mae.MAEConfig(**dict(SMALL, target_length=128)),
        generator=torch.Generator().manual_seed(5))
    want = weights.mae_state_dict_from_jax(params)
    got = pm.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    for k in ("pos_embed", "decoder_pos_embed",
              "decoder_blocks.0.attn.logit_scale"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-7)
    w = got["decoder_blocks.1.attn.qkv.weight"]
    assert w.abs().max() <= (6.0 / (128 + 384)) ** 0.5
    assert not pm.pos_embed.requires_grad and not pm.decoder_pos_embed.requires_grad


def test_config_matches_jax():
    for f in dataclasses.fields(jmae.MAEConfig):
        assert getattr(mae.MAEConfig(), f.name) == f.default, f.name
    assert mae.mae_vit_base_dec512d8b() == mae.MAEConfig(
        **dataclasses.asdict(jmae.mae_vit_base_dec512d8b()))
    with pytest.raises(ValueError, match="window_attention_impl"):
        mae.MAEConfig(window_attention_impl="pallas")
