"""The port's MAE pretrain step (tpat_tpu_torch.engine.pretrain) against the
JAX package's ``make_mae_train_step``, on the CPU, in f32.

The two steps draw their masks and the decoder's meta-MLP dropout from
different generators, so for the comparison the JAX step runs with its
masking noise replaced by numpy noise (``jax.random.uniform`` patched for
the (B, L) draw) and its dropout switched off (``flax.linen.Dropout``
patched to the identity), and the port's step takes the same noise with
``deterministic=True``.  Nothing in the JAX package changes."""

import numpy as np
import pytest
import torch
from flax import linen as flax_nn
from flax import traverse_util

import jax
import jax.numpy as jnp

from tpat_tpu.engine import pretrain as jpretrain
from tpat_tpu.models import mae as jmae
from tpat_tpu_torch.engine import pretrain
from tpat_tpu_torch.models import mae
from tpat_tpu_torch.utils import weights

SMALL = dict(
    embed_dim=96, depth=2, num_heads=3, decoder_embed_dim=128,
    decoder_depth=2, decoder_num_heads=4, decoder_mode=1, num_mel_bins=128,
    window_size=(4, 4), compute_dtype="float32",
)
LR, WD, MASK_RATIO = 1e-3, 0.05, 0.8


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree, sep="/").items()}


def _setup(target_length, impl):
    kw = dict(SMALL, target_length=target_length)
    jm = jmae.MaskedAutoencoderViT(jmae.MAEConfig(window_attention_impl=impl, **kw))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 1, target_length, 128)).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "masking": jax.random.PRNGKey(1)},
                     jnp.asarray(x), MASK_RATIO)["params"]
    pm = mae.MaskedAutoencoderViT(mae.MAEConfig(window_attention_impl=impl, **kw))
    pm.load_state_dict(weights.mae_state_dict_from_jax(params), strict=True)
    noise = rng.uniform(size=(2, pm.cfg.num_patches)).astype(np.float32)
    return jm, params, pm, x, noise


@pytest.fixture
def same_masks_no_dropout(monkeypatch):
    """Returns a function that makes the JAX model draw ``noise`` for its
    (B, L) masking draw and run its meta-MLP dropout as the identity."""

    def patch(noise):
        uniform = jax.random.uniform

        def fixed(key, shape=(), *a, **kw):
            if tuple(shape) == noise.shape:
                return jnp.asarray(noise)
            return uniform(key, shape, *a, **kw)

        monkeypatch.setattr(jax.random, "uniform", fixed)
        monkeypatch.setattr(flax_nn, "Dropout",
                            lambda rate: (lambda x, deterministic=True: x))

    return patch


@pytest.mark.parametrize("target_length,impl", [(128, "fused"), (256, "banded")])
def test_one_step_matches_make_mae_train_step(target_length, impl,
                                              same_masks_no_dropout):
    """One step from the same weights, batch and masks: loss rtol 1e-4,
    every gradient within 1e-4 of its tensor's largest |gradient|, every
    parameter after AdamW rtol 1e-5, the pos embeds unchanged."""
    jm, params, pm, x, noise = _setup(target_length, impl)
    same_masks_no_dropout(noise)

    tx = jpretrain.make_mae_optimizer(params, lr_fn=lambda s: LR,
                                      weight_decay=WD, pos_trainable=False)
    jstep = jpretrain.make_mae_train_step(jm, tx, MASK_RATIO)
    rng = jax.random.PRNGKey(0)

    def jloss(p):
        loss, _, _ = jm.apply({"params": p}, jnp.asarray(x), MASK_RATIO,
                              deterministic=False,
                              rngs={"masking": rng, "dropout": rng})
        return loss

    jgrads = _flat(jax.grad(jloss)(params))
    before = _flat(params)
    new_params, _, jsum = jstep(params, tx.init(params), jnp.zeros(()), rng,
                                jnp.asarray(0), jnp.asarray(x))
    after = _flat(new_params)

    opt = pretrain.make_mae_optimizer(pm, weight_decay=WD, pos_trainable=False)
    step = pretrain.make_mae_train_step(pm, opt, MASK_RATIO, lambda s: LR)
    pos0 = pm.pos_embed.detach().clone(), pm.decoder_pos_embed.detach().clone()
    loss_sum = step(torch.zeros(()), 0, torch.from_numpy(x),
                    noise=torch.from_numpy(noise), deterministic=True)

    np.testing.assert_allclose(loss_sum.item(), float(jsum), rtol=1e-4)
    grads = weights.jax_flat_grads(
        {n: p.grad for n, p in pm.named_parameters()})
    assert set(grads) == set(jgrads) - {"pos_embed", "decoder_pos_embed"}
    for k, g in grads.items():
        scale = np.abs(jgrads[k]).max()
        if k.endswith("meta_fc2/bias"):
            # the sum of d(template): zero in exact arithmetic, noise in both
            assert np.abs(g).max() < 5e-3 and scale < 5e-3, k
            continue
        assert np.abs(g - jgrads[k]).max() <= 1e-4 * scale, k
    got = weights.jax_flat_from_state_dict(pm.state_dict())
    for k, w in after.items():
        # Adam's first update is lr * g / (|g| + eps), about lr * sign(g): an
        # entry whose gradient is below 1e-3 of its tensor's largest (so
        # within 10x the gradient tolerance of 0) may move either way, as
        # the gradients that are zero in exact arithmetic do (k's bias in
        # softmax attention, meta_fc2's bias); those are held by size, every
        # other entry at rtol 1e-5
        g = jgrads.get(k, np.zeros_like(w))
        free = np.abs(g) < 1e-3 * np.abs(g).max()
        if k.endswith("meta_fc2/bias"):
            free[...] = True  # all of it noise
        bound = LR * (1 + 1e-3 + WD * np.abs(before[k]))  # Adam + decay
        assert np.all((np.abs(got[k] - before[k]) <= bound)[free]), k
        np.testing.assert_allclose(got[k][~free], w[~free], rtol=1e-5,
                                   atol=1e-9, err_msg=k)
    assert torch.equal(pm.pos_embed, pos0[0])
    assert torch.equal(pm.decoder_pos_embed, pos0[1])
    np.testing.assert_array_equal(after["pos_embed"], before["pos_embed"])


def test_adamw_matches_the_optax_chain():
    """torch.optim.AdamW (make_mae_optimizer) and the JAX chain
    scale_by_adam -> add_decayed_weights -> -lr give the same parameters
    from the same gradients over three updates, rtol 1e-5."""
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 5), "b": (5,), "pos_embed": (1, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jpretrain.make_mae_optimizer(params, lr_fn=lambda s: LR * (s + 1),
                                      weight_decay=WD, pos_trainable=True)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = pretrain.make_mae_optimizer(module, weight_decay=WD, pos_trainable=True)
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = tx.init(jp)
    for step in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        updates, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                                   state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for group in opt.param_groups:
            group["lr"] = LR * (step + 1)
        for k, p in module.named_parameters():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
    for k, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_decay_mask_matches_jax():
    jm, params, pm, _, _ = _setup(128, "fused")
    for pos_trainable in (False, True):
        want = _flat(jpretrain.mae_decay_mask(params, pos_trainable))
        got = pretrain.mae_decay_mask(pm, pos_trainable)
        names = {n: p for n, p in pm.named_parameters()}
        flat = weights.jax_flat_from_state_dict(
            {n: torch.tensor(float(d)).expand(names[n].shape)
             for n, d in got.items()})
        assert set(flat) == set(want)
        for k, w in want.items():
            assert bool(flat[k].reshape(-1)[0]) == bool(w), k


def test_optimizer_groups_and_lr():
    _, _, pm, _, _ = _setup(128, "fused")
    opt = pretrain.make_mae_optimizer(pm, weight_decay=WD, pos_trainable=False)
    decayed, plain = (g["params"] for g in opt.param_groups)
    assert [g["weight_decay"] for g in opt.param_groups] == [WD, 0.0]
    assert all(p.dim() > 1 for p in decayed) and all(p.dim() <= 1 for p in plain)
    frozen = {id(pm.pos_embed), id(pm.decoder_pos_embed)}
    assert not frozen & {id(p) for p in decayed + plain}
    lr_fn = pretrain.mae_lr_fn(lr=1e-3, min_lr=0.0, warmup_epochs=1, epochs=4,
                               iters_per_epoch=10)
    assert lr_fn(0) == 0.0 and abs(lr_fn(10) - 1e-3) < 1e-12
    assert lr_fn(40) < 1e-12


def test_step_generator_draws_differ_by_step():
    x = torch.zeros(())
    a = torch.rand(4, generator=pretrain.step_generator(0, 1, x.device))
    b = torch.rand(4, generator=pretrain.step_generator(0, 2, x.device))
    c = torch.rand(4, generator=pretrain.step_generator(0, 1, x.device))
    assert not torch.equal(a, b) and torch.equal(a, c)


def test_train_step_with_dropout_and_own_masks_lowers_the_loss():
    """Three steps on one batch through the banded decoder, each drawing its
    masks and dropout from its step generator: finite losses, the loss
    falls, the frozen pos embeds stay."""
    _, _, pm, x, _ = _setup(256, "banded")
    opt = pretrain.make_mae_optimizer(pm, weight_decay=WD, pos_trainable=False)
    step = pretrain.make_mae_train_step(pm, opt, MASK_RATIO, lambda s: LR)
    pos = pm.pos_embed.detach().clone()
    losses, total = [], torch.zeros(())
    for i in range(3):
        new = step(total, i, torch.from_numpy(x))
        losses.append((new - total).item())
        total = new
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert torch.equal(pm.pos_embed, pos)
