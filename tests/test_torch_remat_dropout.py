"""Dropout and remat in the port's AudioViT (tpat_tpu_torch.models.vit)
against the JAX AudioViT and against itself, on the CPU, f32.

The JAX model draws its dropout masks from its own PRNG; the tests record
the masks the port draws from its generator and hand them to the JAX
model in call order (``flax.linen.Dropout`` patched), as the pretrain
test hands the JAX model the port's masking noise."""

import dataclasses

import numpy as np
import pytest
import torch

import flax.linen as flax_nn
import jax
import jax.numpy as jnp

from tpat_tpu.config import ViTConfig
from tpat_tpu.engine import schedules as jschedules
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu_torch.models import vit as vit_lib
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.utils.weights import jax_flat_grads, state_dict_from_jax

# loss, and each gradient within this share of its tensor's largest
# |gradient|: f32 sums in another order through four blocks (the rule of
# test_torch_hybrid.py::test_param_gradients_match_jax)
GRAD_REL = 1e-4


def _cfg(**kw):
    base = dict(
        compute_dtype="float32", embed_dim=64, depth=4, num_heads=2,
        num_classes=5, target_length=128, num_mel_bins=32, drop_loc=(1, 3),
        base_keep_rate=0.6, drop_path_rate=0.0, drop_rate=0.1,
        attention_impl="xla",
    )
    base.update(kw)
    return ViTConfig(**base)


@pytest.fixture(scope="module")
def weights():
    """Sharpened JAX params (qkv N(0, 1), the rest N(0, 0.05^2)), a batch
    and its one-hot targets."""
    cfg = _cfg()
    init = JaxAudioViT(cfg).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 1, 128, 32))
    )["params"]
    rng = np.random.default_rng(3)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        return (rng.normal(size=np.shape(leaf)) * (1.0 if "qkv" in name else 0.05)
                ).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, init)
    x = rng.normal(size=(3, 1, 128, 32)).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[[0, 3, 1]]
    return params, x, y


def _port(cfg, params):
    model = AudioViT(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model


def _loss_and_grads(model, x, y, seed, **kw):
    model.train()
    logits = model(torch.from_numpy(x), generator=torch.Generator().manual_seed(seed),
                   **kw)
    loss = -(torch.from_numpy(y) * torch.log_softmax(logits, -1)).sum(-1).mean()
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.item(), dict(zip([k for k, _ in named], grads))


@pytest.mark.parametrize("forward", ["static", "mask2d", "custom_rank"])
def test_remat_matches_no_remat(weights, forward):
    """Drop-path 0.1 and dropout 0.1 on, one generator seed: with ``remat``
    each block's keep masks are drawn before its checkpoint and passed in,
    so the recompute uses the same masks and the loss and every gradient
    equal those without remat (mirrors tests/test_export_remat.py::
    test_remat_matches_no_remat, which runs deterministic)."""
    params, x, y = weights
    kw = {"static": {}, "mask2d": dict(mask_t_prob=0.3, mask_f_prob=0.3),
          "custom_rank": dict(custom_rank="mean")}[forward]
    cfg = _cfg(drop_path_rate=0.1)
    l0, g0 = _loss_and_grads(_port(cfg, params), x, y, 11, **kw)
    remat = _port(dataclasses.replace(cfg, remat=True), params)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counted(*a, **k):
        calls.append(k.get("use_reentrant"))
        return real(*a, **k)

    torch.utils.checkpoint.checkpoint = counted
    try:
        l1, g1 = _loss_and_grads(remat, x, y, 11, **kw)
    finally:
        torch.utils.checkpoint.checkpoint = real
    assert calls == [False] * cfg.depth
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
    # the masks really drew: another seed gives another loss
    l2, _ = _loss_and_grads(_port(cfg, params), x, y, 12, **kw)
    assert l2 != l0


def test_dropout_eval_matches_jax_deterministic(weights):
    """In eval, drop_rate 0.1 is the identity: the port's logits equal the
    JAX model's deterministic forward (f32 tolerance of the static parity
    tests)."""
    params, x, _ = weights
    cfg = _cfg()
    want = JaxAudioViT(cfg).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port(cfg, params).eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("path", ["static", "hybrid"])
def test_dropout_training_matches_jax_grads(weights, path, monkeypatch):
    """Training at drop_rate 0.1: the masks the port draws (pos_drop, then
    each block's proj, fc1 and fc2 dropouts) go into the JAX model's
    ``nn.Dropout`` calls in the same order; loss within rtol 1e-5 and every
    gradient within 1e-4 of its tensor's largest |gradient| of
    ``jax.grad``."""
    params, x, y = weights
    cfg = _cfg()
    masks = []
    real_keep = vit_lib._keep_mask

    def recording(shape, rate, generator, device, what):
        keep = real_keep(shape, rate, generator, device, what)
        if what == "dropout" and keep is not None:
            masks.append(keep.numpy())
        return keep

    monkeypatch.setattr(vit_lib, "_keep_mask", recording)
    model = _port(cfg, params).train()
    gen = torch.Generator().manual_seed(5)
    xt = torch.from_numpy(x)
    rates = (1.0, 0.7, 1.0, 0.7)
    bucket = jschedules.bucket_keep_rates(rates, base_keep_rate=cfg.base_keep_rate)
    num_left = jschedules.masked_kept_counts(rates, cfg.drop_loc, cfg.num_patches)
    if path == "static":
        logits = model(xt, generator=gen)
    else:
        logits = model.forward_hybrid(xt, rates, num_left=num_left,
                                      bucket_rates=bucket, generator=gen)
    loss = -(torch.from_numpy(y) * torch.log_softmax(logits, -1)).sum(-1).mean()
    named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    got = jax_flat_grads(dict(zip([k for k, _ in named], grads)))
    assert len(masks) == 1 + 3 * cfg.depth

    fed = iter(masks)

    def dropout(rate):
        def call(x, deterministic=True):
            if deterministic or rate == 0.0:
                return x
            return jnp.where(jnp.asarray(next(fed)), x / (1.0 - rate), 0.0)
        return call

    monkeypatch.setattr(flax_nn, "Dropout", dropout)
    jmodel = JaxAudioViT(cfg)
    rngs = {"dropout": jax.random.PRNGKey(0), "droppath": jax.random.PRNGKey(1)}

    def jloss(p):
        if path == "static":
            out = jmodel.apply({"params": p}, jnp.asarray(x), deterministic=False,
                               rngs=rngs)
        else:
            nl = jnp.asarray(num_left, jnp.int32)
            out = jmodel.apply(
                {"params": p}, jnp.asarray(x), jnp.asarray(rates, jnp.float32),
                num_left_array=nl, bucket_rates=bucket, deterministic=False,
                rngs=rngs, method=JaxAudioViT.forward_hybrid)
        return -jnp.mean(jnp.sum(jnp.asarray(y) * jax.nn.log_softmax(out), -1))

    want_loss, want = jax.value_and_grad(jloss)(params)
    assert next(fed, None) is None  # JAX consumed every mask, in order
    want = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k, g in got.items():
        scale = np.abs(want[k]).max()
        assert np.abs(g - want[k]).max() <= GRAD_REL * scale + 1e-9, k
