"""The port's masked-anneal pieces (tpat_tpu_torch.ops.pruning's masked
functions, attention with a token mask, drop-path, 2D masking,
AudioViT.forward_masked and forward_hybrid) and the model's parameter
gradients against the JAX package, on the CPU.

Weights are JAX params drawn from numpy with sharpened qkv (N(0, 1); the
rest N(0, 0.05^2)) and carried across by ``state_dict_from_jax``, so the
top-k choices are well separated across frameworks.  The JAX model runs
attention_impl 'fused' (C = 128: its Pallas kernels run in interpret mode)
or 'xla'; the port runs its plain kernel versions on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import ViTConfig, compose_kept_counts
from tpat_tpu.engine import schedules as jschedules
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu.ops import attention as jattention
from tpat_tpu.ops import pruning as jpruning
from tpat_tpu_torch.models.vit import AudioViT, drop_path
from tpat_tpu_torch.ops import pruning
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.ops.attention import attention_with_scores
from tpat_tpu_torch.utils.weights import jax_flat_grads, state_dict_from_jax


def _scores(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "all_equal":
        return np.full((3, 23), 0.25, np.float32)
    if kind == "few_levels":
        return rng.integers(0, 4, size=(3, 41)).astype(np.float32) / 4
    if kind == "near_tied":
        base = np.float32(0.5)
        return (base + np.spacing(base) * rng.integers(0, 3, size=(3, 37))).astype(
            np.float32
        )
    return rng.normal(size=(3, 29)).astype(np.float32)


@pytest.mark.parametrize("kind", ["all_equal", "few_levels", "near_tied", "normal"])
def test_masked_refine_matches_jax(kind):
    """Kept masks equal JAX's exactly, ties to the lower index, for a
    scalar and a per-sample kept count."""
    scores = _scores(kind, 1)
    rng = np.random.default_rng(2)
    mask = rng.random(scores.shape) < 0.7
    mask[:, 0] = True
    kept = mask.sum(1)
    for num_left in (int(kept.min()) // 2 + 1, np.maximum(kept // 2, 1)):
        got = pruning.masked_refine(
            torch.from_numpy(scores), torch.from_numpy(mask),
            torch.as_tensor(num_left),
        )
        want = jpruning.masked_refine(
            jnp.asarray(scores), jnp.asarray(mask), jnp.asarray(num_left)
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy().sum(1) == np.minimum(num_left, kept)).all()


def test_masked_num_left_and_mean_match_jax():
    """masked_num_left: f32 ceil, equal to JAX's; masked_mean in f32: rtol
    1e-6 (the sum x * mask over the same axis)."""
    kept = np.array([1, 7, 100, 256, 181], np.int32)
    for rate in (0.07, 0.7, 0.775, 0.925, 1.0):
        got = pruning.masked_num_left(rate, torch.from_numpy(kept))
        want = jpruning.masked_num_left(jnp.float32(rate), jnp.asarray(kept))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 13, 8)).astype(np.float32)
    mask = rng.random((4, 13)) < 0.5
    mask[0] = False  # nothing kept: the count floors at 1
    got = pruning.masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
    want = jpruning.masked_mean(jnp.asarray(x), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.all(got.numpy()[0] == 0)


def test_masked_softmax_matches_jax_with_detached_max():
    """Values and gradients vs JAX, whose row max is a stop_gradient: f32
    rtol 1e-6 / atol 1e-7; tied logits and a fully masked row included."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    logits[0, 0] = 1.5  # every logit of the row tied
    key_mask = rng.random((3, 1, 11)) < 0.6
    key_mask[:, :, 0] = True
    key_mask[2] = False  # no key kept: zeros, not NaN
    cot = rng.normal(size=logits.shape).astype(np.float32)

    def jf(v):
        return jnp.sum(jpruning.masked_softmax(v, jnp.asarray(key_mask)) * cot)

    want = np.asarray(jpruning.masked_softmax(jnp.asarray(logits), jnp.asarray(key_mask)))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(logits)))
    t = torch.from_numpy(logits).requires_grad_()
    got = pruning.masked_softmax(t, torch.from_numpy(key_mask))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy(), want_g, rtol=1e-5, atol=1e-7)
    assert np.all(got.detach().numpy()[2] == 0)


@pytest.mark.parametrize("importance,extra", [("patch_mean", 1), ("cls", 2)])
def test_attention_with_token_mask_matches_jax(importance, extra):
    """The masked plain attention (key mask includes the extras; patch_mean
    over kept query rows, denominator h * max(sum(qmask), 1)) vs the JAX XLA
    path: f32 rtol 1e-5 / atol 1e-6."""
    rng = np.random.default_rng(5 + extra)
    b, h, n, d = 3, 2, 15, 16
    q, k, v = (rng.normal(size=(b, h, n, d)).astype(np.float32) for _ in range(3))
    mask = rng.random((b, n - extra)) < 0.6
    mask[:, 0] = True
    out, scores = attention_with_scores(
        *map(torch.from_numpy, (q, k, v)), num_extra_tokens=extra,
        importance=importance, token_mask=torch.from_numpy(mask),
    )
    jout, jscores = jattention.attention_with_scores(
        *map(jnp.asarray, (q, k, v)), num_extra_tokens=extra,
        importance=importance, token_mask=jnp.asarray(mask),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-7)


def test_drop_path_statistics():
    """Per-sample keep with probability 1 - rate (within 5 binomial sigma),
    kept samples scaled by exactly 1 / keep, the rest zero; off in eval and
    at rate 0; the draws follow the generator, not the global RNG."""
    rate, b = 0.3, 20000
    x = torch.randn(b, 3, 4)
    g = torch.Generator().manual_seed(0)
    y = drop_path(x, rate, True, g)
    kept = (y != 0).flatten(1).any(1)
    frac = kept.float().mean().item()
    sigma = (0.7 * 0.3 / b) ** 0.5
    assert abs(frac - 0.7) < 5 * sigma
    assert torch.equal(y[kept], x[kept] / 0.7)
    assert torch.equal(y[~kept], torch.zeros_like(x[~kept]))
    assert drop_path(x, rate, False, None) is x
    assert drop_path(x, 0.0, True, None) is x
    torch.manual_seed(123)
    again = drop_path(x, rate, True, torch.Generator().manual_seed(0))
    assert torch.equal(again, y)
    with pytest.raises(ValueError, match="generator"):
        drop_path(x, rate, True, None)


# --- model level ------------------------------------------------------------

def _cfg(**kw):
    base = dict(
        compute_dtype="float32", embed_dim=128, depth=4, num_heads=2,
        num_classes=5, target_length=128, num_mel_bins=32, drop_loc=(1, 3),
        base_keep_rate=0.5, drop_path_rate=0.0,
    )
    base.update(kw)
    return ViTConfig(**base)


def _sharpened(cfg, seed=0):
    # the param tree does not depend on attention_impl; 'xla' inits fast
    init = JaxAudioViT(dataclasses.replace(cfg, attention_impl="xla")).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 1, 128, 32))
    )["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        return (rng.normal(size=np.shape(leaf)) * (1.0 if "qkv" in name else 0.05)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, init)


@pytest.fixture(scope="module")
def weights():
    params = _sharpened(_cfg())
    x = np.random.default_rng(6).normal(size=(3, 1, 128, 32)).astype(np.float32)
    return params, x


def _port(cfg, params):
    model = AudioViT(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def _anneal_args(cfg, exact):
    rates = tuple(exact if i in cfg.drop_loc else 1.0 for i in range(cfg.depth))
    bucket = jschedules.bucket_keep_rates(rates, base_keep_rate=cfg.base_keep_rate)
    nl = jschedules.masked_kept_counts(rates, cfg.drop_loc, cfg.num_patches)
    return rates, bucket, nl


@pytest.mark.parametrize("impl", ["fused", "xla"])
@pytest.mark.parametrize("exact", [0.77, 0.61, 0.5])
def test_forward_masked_and_hybrid_match_jax(weights, impl, exact):
    """forward_masked and forward_hybrid at mid-anneal rates vs JAX's, same
    attention_impl: logits rtol 2e-3 / atol 1e-4 (the tolerance of
    test_hybrid_fused_prefix_matches_xla).  Mirrors
    test_hybrid_matches_masked_sweep: the port's hybrid equals its masked
    forward within rtol 2e-3 / atol 5e-4."""
    params, x = weights
    cfg = _cfg(attention_impl=impl)
    rates, bucket, nl = _anneal_args(cfg, exact)
    jmodel = JaxAudioViT(cfg)
    kr = jnp.asarray(rates, jnp.float32)
    nla = jnp.asarray(nl, jnp.int32)
    # jitted: the interpret-mode Pallas kernels run compiled, not op by op
    want_m = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, kr, num_left_array=nla,
        method=JaxAudioViT.forward_masked))(params, jnp.asarray(x))
    want_h = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, kr, num_left_array=nla, bucket_rates=bucket,
        method=JaxAudioViT.forward_hybrid))(params, jnp.asarray(x))
    model = _port(cfg, params)
    before = (qa.launches, qa.prefix_launches)
    with torch.no_grad():
        got_m = model.forward_masked(torch.from_numpy(x), rates, num_left=nl)
        got_h = model.forward_hybrid(torch.from_numpy(x), rates, num_left=nl,
                                     bucket_rates=bucket)
        got_m_f32ceil = model.forward_masked(torch.from_numpy(x), rates)
    assert (qa.launches, qa.prefix_launches) == before == (0, 0)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got_h.numpy(), got_m.numpy(), rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(got_m_f32ceil.numpy(), got_m.numpy(), rtol=1e-6, atol=1e-7)


def test_hybrid_fused_prefix_matches_xla(weights):
    """The prefix kernel path (its plain version on the CPU) vs the
    boolean-mask attention through the whole forward_hybrid: rtol 2e-3 /
    atol 1e-4, as the JAX test of that name."""
    params, x = weights
    rates, bucket, nl = _anneal_args(_cfg(), 0.8)
    out = {}
    for impl in ("fused", "xla"):
        with torch.no_grad():
            out[impl] = _port(_cfg(attention_impl=impl), params).forward_hybrid(
                torch.from_numpy(x), rates, num_left=nl, bucket_rates=bucket
            )
    np.testing.assert_allclose(out["fused"].numpy(), out["xla"].numpy(),
                               rtol=2e-3, atol=1e-4)


def test_hybrid_uses_the_prefix_after_the_first_drop_block(weights, monkeypatch):
    """With attention_impl 'fused', blocks up to the first drop block run the
    plain form and every later block the prefix form, with kv_valid = 1 +
    the last drop block's exact kept count."""
    params, x = weights
    cfg = _cfg()
    rates, bucket, nl = _anneal_args(cfg, 0.61)
    calls = []
    import tpat_tpu_torch.models.vit as vit

    plain_fn, prefix_fn = vit.fused_qkv_attention, vit.fused_qkv_attention_prefix
    monkeypatch.setattr(vit, "fused_qkv_attention",
                        lambda qkv, *a: calls.append(("plain", qkv.shape[1], None))
                        or plain_fn(qkv, *a))
    monkeypatch.setattr(vit, "fused_qkv_attention_prefix",
                        lambda qkv, kv, *a: calls.append(("prefix", qkv.shape[1], kv))
                        or prefix_fn(qkv, kv, *a))
    with torch.no_grad():
        _port(cfg, params).forward_hybrid(torch.from_numpy(x), rates, num_left=nl,
                                          bucket_rates=bucket)
    counts = compose_kept_counts(bucket, cfg.num_patches)
    assert calls == [
        ("plain", 1 + cfg.num_patches, None),
        ("plain", 1 + cfg.num_patches, None),
        ("prefix", 1 + counts[1], 1 + nl[1]),
        ("prefix", 1 + counts[1], 1 + nl[1]),
    ]


def _ce(logits, y):
    return -(y * jax.nn.log_softmax(logits, axis=-1)).sum(-1).mean()


@pytest.mark.parametrize("path", ["static", "hybrid"])
def test_param_gradients_match_jax(weights, path):
    """Gradients of the soft-target CE loss with respect to every parameter,
    port (autograd through the plain kernel versions) vs jax.grad (through
    the Pallas custom VJPs), mapped to flax keys by jax_flat_grads: per
    tensor within 1e-4 of its largest |gradient| (f32 sums in another
    order through four blocks)."""
    params, x = weights
    cfg = _cfg()
    y = np.eye(cfg.num_classes, dtype=np.float32)[[0, 3, 1]]
    rates, bucket, nl = _anneal_args(cfg, 0.61)
    jmodel = JaxAudioViT(cfg)

    def jloss(p):
        if path == "static":
            logits = jmodel.apply({"params": p}, jnp.asarray(x))
        else:
            logits = jmodel.apply(
                {"params": p}, jnp.asarray(x), jnp.asarray(rates, jnp.float32),
                num_left_array=jnp.asarray(nl, jnp.int32), bucket_rates=bucket,
                method=JaxAudioViT.forward_hybrid,
            )
        return _ce(logits, jnp.asarray(y))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path_): np.asarray(v)
            for path_, v in jax.tree_util.tree_flatten_with_path(want)[0]}

    model = _port(cfg, params)
    xt = torch.from_numpy(x)
    logits = (model(xt) if path == "static" else
              model.forward_hybrid(xt, rates, num_left=nl, bucket_rates=bucket))
    loss = -(torch.from_numpy(y) * torch.log_softmax(logits, -1)).sum(-1).mean()
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(
        loss, [p for p in named.values() if p.requires_grad]
    )
    got = jax_flat_grads(dict(zip(
        [k for k, p in named.items() if p.requires_grad], grads
    )))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want) - {"pos_embed"}  # frozen: no gradient
    assert not np.any(want["pos_embed"])
    for k, g in got.items():
        scale = np.abs(want[k]).max()
        assert np.abs(g - want[k]).max() <= 1e-4 * scale + 1e-9, k


def _patch_noise(monkeypatch, noise):
    """Hand numpy noise to the JAX package's 2D masking, in call order."""
    it = iter(noise)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(next(it)))


def test_embed_masked2d_matches_jax(weights, monkeypatch):
    """2D masking with the same numpy noise in both packages: keep_t =
    int(T (1 - p)) time rows, then keep_f frequency columns, tokens in the
    permuted order, CLS + pos row 0 in front; tokens exactly equal to JAX's,
    and the dense forward's logits within rtol 1e-3 / atol 2e-4."""
    params, x = weights
    cfg = _cfg(base_keep_rate=1.0, drop_loc=())
    p = 0.3
    rng = np.random.default_rng(7)
    noise = (rng.random((3, cfg.grid_t)).astype(np.float32),
             rng.random((3, cfg.grid_f)).astype(np.float32))
    _patch_noise(monkeypatch, noise)
    jmodel = JaxAudioViT(cfg)
    want = jmodel.apply({"params": params}, jnp.asarray(x), p, p, True,
                        method=JaxAudioViT._embed_masked2d,
                        rngs={"mask2d": jax.random.PRNGKey(0)})
    model = _port(cfg, params)
    with torch.no_grad():
        got = model.embed_masked2d(torch.from_numpy(x), p, p,
                                   tuple(map(torch.from_numpy, noise)))
    keep_t, keep_f = int(cfg.grid_t * (1 - p)), int(cfg.grid_f * (1 - p))
    assert got.shape == (3, 1 + keep_t * keep_f, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    cls = (model.cls_token + model.pos_embed[:, :1]).detach()
    torch.testing.assert_close(got[:, :1], cls.expand(3, 1, -1))

    # the first kept time row is argmin(noise_t), its first kept column
    # argmin(noise_f): token 1 is that patch plus its pos row
    with torch.no_grad():
        patches = model.patch_embed(torch.from_numpy(x)) + model.pos_embed[:, 1:]
    r, c = noise[0].argmin(1), noise[1].argmin(1)
    idx = torch.from_numpy(r * cfg.grid_f + c)
    torch.testing.assert_close(got[:, 1], patches[torch.arange(3), idx])

    _patch_noise(monkeypatch, noise)
    want_logits = jmodel.apply({"params": params}, jnp.asarray(x),
                               mask_t_prob=p, mask_f_prob=p,
                               rngs={"mask2d": jax.random.PRNGKey(0)})
    with torch.no_grad():
        g = torch.Generator().manual_seed(0)
        model_noise = tuple(map(torch.from_numpy, noise))
        import tpat_tpu_torch.models.vit as vit

        monkeypatch.setattr(vit, "mask2d_noise", lambda *a, **k: model_noise)
        got_logits = model(torch.from_numpy(x), mask_t_prob=p, mask_f_prob=p,
                           generator=g)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-3, atol=2e-4)


def test_masked_paths_refuse_what_is_not_ported():
    cfg = _cfg()
    model = AudioViT(cfg).eval()
    x = torch.zeros(1, 1, 128, 32)
    with pytest.raises(ValueError, match="bucket_rates"):
        model.forward_hybrid(x, cfg.keep_rates, num_left=(16,) * 4,
                             bucket_rates=(1.0,))
    # dropout is ported: in training it needs the generator
    with pytest.raises(ValueError, match="dropout"):
        AudioViT(dataclasses.replace(cfg, drop_rate=0.1)).forward_masked(
            x, cfg.keep_rates
        )
