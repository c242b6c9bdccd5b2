"""The port's MAE with the plain transformer decoder (``decoder_mode=0``)
against the JAX package's, on the CPU, in f32; the MAE importer
(``utils/torch_import.py::mae_state_dict_for``); and the packed-qkv
attention at head_dim 32, the plain decoder's.

The model has test_torch_mae's SMALL widths with ``decoder_mode=0`` at 64
frames: a decoder 128 wide with 4 heads, head_dim 32, so the JAX side runs its Pallas attention
kernel there (in interpret mode, as tests/test_mae.py runs it) and the
port's wrappers their plain versions on CPU tensors.  Weights come from the
JAX init through the reference ``.pth`` layout; the port is handed the JAX
masking noise."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

from tpat_tpu.engine import pretrain as jpretrain
from tpat_tpu.models import mae as jmae
from tpat_tpu.ops import pallas_attention as jpa
from tpat_tpu.utils import torch_export as jte
from tpat_tpu_torch import config as cfg_lib
from tpat_tpu_torch.cli import pretrain as cli_pretrain
from tpat_tpu_torch.engine import pretrain
from tpat_tpu_torch.models import mae
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.utils import torch_import as ti
from tpat_tpu_torch.utils import weights

PLAIN = dict(
    embed_dim=96, depth=2, num_heads=3, decoder_embed_dim=128,
    decoder_depth=2, decoder_num_heads=4, decoder_mode=0, num_mel_bins=128,
    window_size=(4, 4), compute_dtype="float32", target_length=64,
)
MASK_RATIO, LR, WD = 0.75, 1e-3, 0.05


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port's model with them, an input)."""
    jm = jmae.MaskedAutoencoderViT(jmae.MAEConfig(**PLAIN))
    x = np.random.default_rng(1).normal(size=(2, 1, 64, 128)).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "masking": jax.random.PRNGKey(1)},
                     jnp.asarray(x), MASK_RATIO)["params"]
    pm = mae.MaskedAutoencoderViT(mae.MAEConfig(**PLAIN))
    pm.load_state_dict(weights.mae_state_dict_from_jax(params), strict=True)
    return jm, params, pm, x


def _jax_noise(key, b, cfg, mask_2d):
    """The noise the JAX model draws from ``rng=key`` (as test_torch_mae)."""
    if mask_2d:
        kt, kf = jax.random.split(key)
        t, f = cfg.grid
        return (torch.from_numpy(np.array(jax.random.uniform(kt, (b, t)))),
                torch.from_numpy(np.array(jax.random.uniform(kf, (b, f)))))
    return torch.from_numpy(np.array(
        jax.random.uniform(key, (b, cfg.num_patches))))


def _within(got, want, rel, what):
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale, what


@pytest.mark.parametrize("mask_2d", [False, True])
def test_forward_and_loss_match_jax(models, mask_2d):
    """Loss and pred within 1e-5 of the largest entry, the mask equal."""
    jm, params, pm, x = models
    key = jax.random.PRNGKey(7)
    jloss, jpred, jmask = jm.apply({"params": params}, jnp.asarray(x),
                                   MASK_RATIO, rng=key, mask_2d=mask_2d)
    with torch.no_grad():
        loss, pred, m = pm(torch.from_numpy(x), MASK_RATIO, mask_2d=mask_2d,
                           noise=_jax_noise(key, 2, pm.cfg, mask_2d))
    assert pred.shape == (2, pm.cfg.num_patches, 256)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))
    _within(np.array([loss.item()]), np.array([float(jloss)]), 1e-5, "loss")
    _within(pred.numpy(), np.asarray(jpred), 1e-5, "pred")


def test_parameter_gradients_match_jax(models):
    """Every parameter gradient within 1e-4 of its tensor's largest |entry|
    against ``jax.grad``, entry by entry under the flat flax keys (the
    plain decoder's ``decoder_blocks_{i}/...``); the frozen pos embeds take
    none."""
    jm, params, pm, x = models
    key = jax.random.PRNGKey(3)

    def jloss(p):
        return jm.apply({"params": p}, jnp.asarray(x), MASK_RATIO, rng=key)[0]

    want = _flat(jax.grad(jloss)(params))
    named = [(n, p) for n, p in pm.named_parameters() if p.requires_grad]
    loss, _, _ = pm(torch.from_numpy(x), MASK_RATIO,
                    noise=_jax_noise(key, 2, pm.cfg, False))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    got = weights.jax_flat_grads(dict(zip((n for n, _ in named), grads)))
    assert set(got) == set(want) - {"pos_embed", "decoder_pos_embed"}
    assert "decoder_blocks_1/attn/qkv/kernel" in got
    for k, g in got.items():
        _within(g, want[k], 1e-4, k)


def test_train_step_matches_make_mae_train_step(models, monkeypatch):
    """One step of ``engine/pretrain.py`` against ``make_mae_train_step``
    from the same weights and batch, the JAX step's (B, L) masking draw
    replaced by numpy noise that the port's step takes too: the loss
    within rtol 1e-4 and every parameter after AdamW within rtol 1e-4 of
    JAX's where its gradient is not near 0 (where it is, Adam's first
    update, about lr * sign(g), may go either way: held by the bound)."""
    jm, params, _, x = models
    noise = np.random.default_rng(4).uniform(
        size=(2, jm.cfg.num_patches)).astype(np.float32)
    uniform = jax.random.uniform

    def fixed(key, shape=(), *a, **kw):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise)
        return uniform(key, shape, *a, **kw)

    monkeypatch.setattr(jax.random, "uniform", fixed)
    tx = jpretrain.make_mae_optimizer(params, lr_fn=lambda s: LR,
                                      weight_decay=WD, pos_trainable=False)
    jgrads = _flat(jax.grad(lambda p: jm.apply(
        {"params": p}, jnp.asarray(x), MASK_RATIO,
        rngs={"masking": jax.random.PRNGKey(0)})[0])(params))
    jstep = jpretrain.make_mae_train_step(jm, tx, MASK_RATIO)
    before = _flat(params)
    new, _, jsum = jstep(jax.tree_util.tree_map(jnp.array, params),
                         tx.init(params), jnp.zeros(()), jax.random.PRNGKey(0),
                         jnp.asarray(0), jnp.asarray(x))
    after = _flat(new)

    pm = mae.MaskedAutoencoderViT(mae.MAEConfig(**PLAIN))
    pm.load_state_dict(weights.mae_state_dict_from_jax(params), strict=True)
    opt = pretrain.make_mae_optimizer(pm, weight_decay=WD, pos_trainable=False)
    step = pretrain.make_mae_train_step(pm, opt, MASK_RATIO, lambda s: LR)
    loss_sum = step(torch.zeros(()), 0, torch.from_numpy(x),
                    noise=torch.from_numpy(noise))
    np.testing.assert_allclose(loss_sum.item(), float(jsum), rtol=1e-4)
    got = weights.jax_flat_from_state_dict(pm.state_dict())
    for k, w in after.items():
        g = jgrads[k]
        free = np.abs(g) < 1e-3 * max(np.abs(g).max(), 1e-30)
        bound = LR * (1 + 1e-3 + WD * np.abs(before[k]))
        assert np.all((np.abs(got[k] - before[k]) <= bound)[free]), k
        np.testing.assert_allclose(got[k][~free], w[~free], rtol=1e-4,
                                   atol=1e-9, err_msg=k)


def test_export_import_roundtrip(models, tmp_path):
    """JAX ``save_pth(flavor='mae')`` -> ``load_pth`` ->
    ``mae_state_dict_for`` -> ``load_state_dict(strict=True)``: every
    tensor equal to the JAX params' (test_mae.py's round trip, plain
    decoder)."""
    _, params, _, _ = models
    path = str(tmp_path / "mae.pth")
    jte.save_pth(path, params, flavor="mae", epoch=3)
    cfg = mae.MAEConfig(**PLAIN)
    sd = ti.mae_state_dict_for(weights.load_pth(path), cfg)
    pm = mae.MaskedAutoencoderViT(cfg)
    pm.load_state_dict(sd, strict=True)
    got, want = weights.jax_flat_from_state_dict(pm.state_dict()), _flat(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("change,named", [
    (dict(decoder_mode=1), "decoder_mode"),
    (dict(target_length=128), "patches"),
    (dict(decoder_depth=3), "decoder_depth"),
])
def test_importer_refuses_a_mismatched_checkpoint(models, change, named):
    """A plain-decoder checkpoint into a model of another decoder flavour,
    grid or depth: a ValueError naming the mismatch."""
    _, params, _, _ = models
    sd = weights.mae_state_dict_from_jax(params)
    with pytest.raises(ValueError, match=named):
        ti.mae_state_dict_for(sd, mae.MAEConfig(**dict(PLAIN, **change)))


def test_flat_keys_map_plain_decoder_blocks(models):
    """``jax_flat_from_state_dict`` maps the plain decoder's
    ``decoder_blocks.{i}.*`` keys to ``decoder_blocks_{i}/...``: the port's
    state dict gives the JAX params' key set and values."""
    _, params, pm, _ = models
    flat = weights.jax_flat_from_state_dict(pm.state_dict())
    want = _flat(params)
    assert set(flat) == set(want)
    for k in ("decoder_blocks_0/norm1/scale", "decoder_blocks_1/mlp/fc2/kernel",
              "decoder_blocks_1/attn/proj/bias"):
        np.testing.assert_array_equal(flat[k], want[k])


@pytest.mark.parametrize("mode,extra", [(None, 1), ("patch_mean", 1)])
def test_qkv_attention_head_dim_32_matches_jax(mode, extra):
    """B1 and B3 at head_dim 32 (B = 2, N = 33, H = 4; CPU: their plain
    versions) against the JAX Pallas kernel and its ``jax.vjp``: out atol
    1e-5, scores rtol 1e-3, d_qkv within 1e-4 of its largest entry."""
    h, d, n = 4, 32, 33
    rng = np.random.default_rng(32)
    qkv = rng.normal(size=(2, n, 3 * h * d)).astype(np.float32)
    d_out = rng.normal(size=(2, n, h * d)).astype(np.float32)
    jout, jvjp = jax.vjp(lambda t: jpa.fused_qkv_attention(t, h, mode, extra),
                         jnp.asarray(qkv))
    t = torch.from_numpy(qkv).requires_grad_()
    out, scores = qa.fused_qkv_attention(t, h, mode, extra)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout[0]),
                               rtol=0, atol=1e-5)
    d_scores = None
    if mode is not None:
        np.testing.assert_allclose(scores.detach().numpy(),
                                   np.asarray(jout[1]), rtol=1e-3, atol=1e-7)
        d_scores = rng.normal(size=scores.shape).astype(np.float32)
    (jd,) = jvjp((jnp.asarray(d_out),
                  None if d_scores is None else jnp.asarray(d_scores)))
    grads = [torch.from_numpy(d_out)]
    outs = [out]
    if d_scores is not None:
        grads.append(torch.from_numpy(d_scores))
        outs.append(scores)
    (got,) = torch.autograd.grad(outs, [t], grads)
    _within(got.numpy(), np.asarray(jd), 1e-4, "d_qkv")
    assert qa.launches == qa.bwd_rows_launches == 0


def test_kernels_take_every_reachable_head_dim():
    """``supports`` holds for the head_dim of every model the port can
    build: the config presets' ViTs and the MAEs' encoders and decoders
    (mae_vit_base_dec512d8b and the pretrain CLI's tiny model)."""
    dims = set()
    for name, fn in inspect.getmembers(cfg_lib, inspect.isfunction):
        try:
            c = fn()
        except (TypeError, ValueError):  # not a preset, or needs arguments
            continue
        if isinstance(c, cfg_lib.ViTConfig):
            dims.add((name, c.num_heads, c.embed_dim // c.num_heads))
    data_cfg = dataclasses.replace(cfg_lib.DATASET_PRESETS["audioset"])
    for model in ("mae_vit_base", "mae_vit_tiny"):
        args = cli_pretrain.get_args_parser().parse_args(
            ["--data_train", "x", "--label_csv", "y", "--model", model])
        m = cli_pretrain.model_config(args, data_cfg)
        for c in (m.encoder_vit_config(), m.decoder_vit_config()):
            dims.add((model, c.num_heads, c.embed_dim // c.num_heads))
    assert {d for _, _, d in dims} >= {32, 64}
    for name, h, d in dims:
        assert qa.supports(h, d, 513), (name, h, d)
