"""The port's training engine (tpat_tpu_torch.engine: schedules, optimizer,
losses, TrainModule.train_epoch) against the JAX package's, on the CPU.

Weights are JAX params drawn from numpy with sharpened qkv (N(0, 1); the
rest N(0, 0.05^2)), carried across by ``state_dict_from_jax``, so top-k
choices stay well separated over a few optimizer updates.  The JAX engine
runs attention_impl 'xla' (its plain reference: one compile per step
variant); the port runs 'fused', whose kernel wrappers take their plain
forward and backward on CPU tensors."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import TrainConfig, ViTConfig
from tpat_tpu.engine import optimizer as jopt
from tpat_tpu.engine import schedules as jsched
from tpat_tpu.engine import train as jtrain
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu_torch.engine import optimizer as opt
from tpat_tpu_torch.engine import schedules
from tpat_tpu_torch.engine import train
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.utils.weights import jax_flat_from_state_dict, state_dict_from_jax


def _cfg(**kw):
    base = dict(
        compute_dtype="float32", embed_dim=128, depth=3, num_heads=2,
        num_classes=5, target_length=128, num_mel_bins=32, drop_loc=(1, 2),
        base_keep_rate=0.5, drop_path_rate=0.0,
    )
    base.update(kw)
    return ViTConfig(**base)


def _tc(**kw):
    base = dict(
        batch_size=4, epochs=4, blr=1e-3, min_lr=1e-5, warmup_epochs=1,
        base_keep_rate=0.5, drop_loc=(1, 2), shrink_start_epoch=1,
        shrink_epochs=2, anneal_mode="hybrid", anneal_buckets=4,
    )
    base.update(kw)
    return TrainConfig(**base)


def _sharpened(cfg, seed=0):
    # the param tree does not depend on attention_impl; 'xla' inits fast
    init = JaxAudioViT(dataclasses.replace(cfg, attention_impl="xla")).init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 1, cfg.target_length, cfg.num_mel_bins)),
    )["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name == "pos_embed":  # the frozen sin-cos table stays
            return np.asarray(leaf)
        return (rng.normal(size=np.shape(leaf)) * (1.0 if "qkv" in name else 0.05)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, init)


def _batches(cfg, n, b, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y_idx = rng.integers(0, cfg.num_classes, size=b)
        x = rng.normal(size=(b, 1, cfg.target_length, cfg.num_mel_bins))
        x[np.arange(b), 0, 0, 0] = y_idx * 2.0  # class-dependent: learnable
        out.append((x.astype(np.float32),
                    np.eye(cfg.num_classes, dtype=np.float32)[y_idx]))
    return out


def _flax_key(name):
    """The flat flax key of a port parameter name."""
    (key,) = jax_flat_from_state_dict({name: torch.zeros(2, 2)})
    return key


# --- schedules ----------------------------------------------------------

def test_schedules_match_jax():
    """Keep-rate cosine, buckets, kept counts, phases and the LR schedule
    vs tpat_tpu.engine.schedules over a grid: equal, and the LR within f32
    rounding (JAX evaluates the cosine in f32, the port in double)."""
    for iters_per_epoch in (1, 3, 20):
        for base in (0.5, 0.7, 1 / 3):
            for epoch in range(0, 7):
                for it in range(epoch * iters_per_epoch,
                                (epoch + 1) * iters_per_epoch):
                    kw = dict(shrink_start_epoch=2, total_epochs=5,
                              iters_per_epoch=iters_per_epoch,
                              base_keep_rate=base, num_blocks=12,
                              drop_loc=(3, 6, 9))
                    rates = schedules.scheduled_keep_rates(it, epoch, **kw)
                    assert rates == jsched.scheduled_keep_rates(it, epoch, **kw)
                    if rates is None:
                        continue
                    for nb in (2, 3, 4, 6):
                        assert schedules.bucket_keep_rates(
                            rates, base_keep_rate=base, n_buckets=nb
                        ) == jsched.bucket_keep_rates(
                            rates, base_keep_rate=base, n_buckets=nb)
                    for p in (16, 256, 512):
                        assert schedules.masked_kept_counts(
                            rates, (3, 6, 9), p
                        ) == jsched.masked_kept_counts(rates, (3, 6, 9), p)
                kw = dict(shrink_start_epoch=2, shrink_epochs=3,
                          base_keep_rate=base)
                assert schedules.schedule_phase(epoch, **kw) == \
                    jsched.schedule_phase(epoch, **kw)
    assert schedules.schedule_phase(
        9, shrink_start_epoch=2, shrink_epochs=3, base_keep_rate=1.0) == "dense"
    with pytest.raises(ValueError):
        schedules.bucket_keep_rates((0.8,), base_keep_rate=0.7, n_buckets=1)
    for e in np.linspace(0.0, 60.0, 97):
        kw = dict(lr=5e-4, min_lr=1e-6, warmup_epochs=5.0, total_epochs=60)
        got = schedules.warmup_cosine_lr(float(e), **kw)
        want = float(jsched.warmup_cosine_lr(float(e), **kw))
        # JAX's cosine is f32: its error is f32 eps of the lr-sized terms
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-7 * 5e-4)


# --- optimizer ----------------------------------------------------------

def test_param_groups_match_jax_scale_and_decay_trees():
    """Every trainable port parameter's lr scale and decay flag equal
    lr_scale_tree's and wd_mask_tree's at its flax key; the frozen
    pos_embed (scale 0 in JAX) is left out of the groups."""
    cfg = _cfg()
    model = AudioViT(cfg)
    params = _sharpened(cfg)
    scales = jax.tree_util.tree_flatten_with_path(
        jopt.lr_scale_tree(params, cfg.depth, 0.75, True))[0]
    masks = jax.tree_util.tree_flatten_with_path(jopt.wd_mask_tree(params))[0]

    def flat(items):
        return {"/".join(str(getattr(k, "key", k)) for k in p): v for p, v in items}

    scales, masks = flat(scales), flat(masks)
    seen = set()
    for group in opt.param_groups(model, cfg.depth, 0.05, 0.75):
        for name in group["names"]:
            key = _flax_key(name)
            seen.add(key)
            assert group["lr_scale"] == pytest.approx(scales[key], rel=1e-12), name
            assert (group["weight_decay"] == 0.05) == bool(masks[key]), name
    assert seen == set(scales) - {"pos_embed"}
    assert scales["pos_embed"] == 0.0


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_updates_match_optax(clip):
    """Three updates from the same gradients: the port's AdamW groups with
    lr_fn(update) * scale vs the JAX optax chain (clip, Adam, masked decay,
    per-leaf scale, schedule): parameters within rtol 1e-5 / atol 1e-7
    (Adam's first steps move each weight by ~lr whatever the gradient)."""
    cfg = _cfg()
    tc = _tc(warmup_epochs=0.5, weight_decay=0.05, clip_grad=clip)
    params = _sharpened(cfg)
    model = AudioViT(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    lr_fn = opt.make_lr_fn(tc, 2, 4)
    jlr_fn = jopt.make_lr_fn(tc, 2, 4)
    assert [lr_fn(u) for u in range(3)] == pytest.approx(
        [float(jlr_fn(u)) for u in range(3)], rel=1e-6)
    tx = jopt.make_optimizer(params, cfg, tc, jlr_fn)
    state = tx.init(params)
    update = jax.jit(tx.update)
    optimizer = opt.make_optimizer(model, cfg, tc)
    named = [(n, p) for g in optimizer.param_groups
             for n, p in zip(g["names"], g["params"])]
    rng = np.random.default_rng(9)
    jparams = params
    for u in range(3):
        grads_np = {n: rng.normal(size=p.shape).astype(np.float32)
                    for n, p in named}
        grads = [torch.from_numpy(grads_np[n]) for n, _ in named]
        if clip is not None:
            opt.clip_by_global_norm_(grads, clip)
        for (_, p), g in zip(named, grads):
            p.grad = g
        opt.set_lr(optimizer, lr_fn(u))
        optimizer.step()
        jgrads_flat = jax_flat_from_state_dict(
            {n: torch.from_numpy(grads_np[n]) for n, _ in named})
        jgrads = jax.tree_util.tree_map_with_path(
            lambda path, leaf: jnp.asarray(jgrads_flat.get(
                "/".join(str(getattr(k, "key", k)) for k in path),
                np.zeros(np.shape(leaf), np.float32))),
            jparams)
        updates, state = update(jgrads, state, jparams)
        jparams = jax.tree_util.tree_map(lambda a, b: a + b, jparams, updates)
    got = jax_flat_from_state_dict(dict(model.named_parameters()))
    want = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)


def test_global_grad_norm_and_clip():
    g = [torch.full((3,), 2.0), torch.full((2, 2), 1.0)]
    assert opt.global_grad_norm(g).item() == pytest.approx(4.0)
    opt.clip_by_global_norm_(g, 1.0)
    assert opt.global_grad_norm(g).item() == pytest.approx(1.0)
    opt.clip_by_global_norm_(g, 10.0)  # under the limit: unchanged
    assert opt.global_grad_norm(g).item() == pytest.approx(1.0)


# --- losses -------------------------------------------------------------

@pytest.mark.parametrize("name", ["ce", "bce", "ce_hard"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 7)).astype(np.float32)
    targets = rng.uniform(size=(6, 7)).astype(np.float32)
    targets /= targets.sum(1, keepdims=True)
    got = train.LOSS_FNS[name](torch.from_numpy(logits), torch.from_numpy(targets))
    want = jtrain.LOSS_FNS[name](jnp.asarray(logits), jnp.asarray(targets))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# --- train_epoch --------------------------------------------------------

def _jax_run(cfg, tc, params, batches, epochs):
    mod = jtrain.TrainModule(
        model=JaxAudioViT(dataclasses.replace(cfg, attention_impl="xla")),
        model_cfg=dataclasses.replace(cfg, attention_impl="xla"),
        train_cfg=tc, loss_type="ce", iters_per_epoch=len(batches),
    )
    state = mod.load(params)
    out = []
    for epoch in range(epochs):
        state, stats = mod.train_epoch(state, batches, epoch)
        out.append(stats)
    return out


def _port_run(cfg, tc, params, batches, epochs):
    mod = train.TrainModule(cfg, tc, "ce", iters_per_epoch=len(batches),
                            device="cpu")
    state = mod.load(state_dict_from_jax(params))
    out = []
    for epoch in range(epochs):
        state, stats = mod.train_epoch(state, batches, epoch)
        out.append(stats)
    return out, state


@pytest.mark.parametrize("mode,accum", [
    ("hybrid", 1), ("hybrid", 2), ("masked", 1), ("bucketed", 1),
])
def test_train_epoch_matches_jax(mode, accum):
    """Four epochs (dense, anneal at rates 1.0, anneal at 0.75 -- bucket
    0.83 in hybrid mode -- and static), two steps each, from the same
    weights and batches, no drop-path or masking, f32: the phases are
    equal, and per-epoch loss and grad norm within rtol 1e-4."""
    cfg = _cfg()
    tc = _tc(anneal_mode=mode, accum_iter=accum)
    params = _sharpened(cfg)
    batches = _batches(cfg, 2, 4, seed=3)
    want = _jax_run(cfg, tc, params, batches, 4)
    got, state = _port_run(cfg, tc, params, batches, 4)
    assert [s["phase"] for s in got] == [s["phase"] for s in want] == [
        "dense", "anneal", "anneal", "static"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    assert state.step == 8
    assert qa.launches == qa.prefix_launches == qa.bwd_rows_launches == 0


def test_train_phases_and_loss_decreases():
    """Mirror of the JAX engine test, port only, with drop-path and 2D
    masking on: the phases, a decreasing loss, a frozen pos_embed."""
    cfg = _cfg(base_keep_rate=0.6, drop_loc=(1,), drop_path_rate=0.1)
    tc = _tc(epochs=6, blr=2e-3, base_keep_rate=0.6, drop_loc=(1,),
             mask_t_prob=0.2, mask_f_prob=0.2)
    batches = _batches(cfg, 4, 8, seed=0)
    mod = train.TrainModule(cfg, tc, "ce", iters_per_epoch=4, device="cpu")
    state = mod.init()
    pos0 = state.model.pos_embed.detach().clone()
    phases, losses = [], []
    for epoch in range(6):
        state, stats = mod.train_epoch(state, batches, epoch)
        phases.append(stats["phase"])
        losses.append(stats["loss"])
        assert math.isfinite(stats["grad_norm"])
    assert phases == ["dense", "anneal", "anneal", "static", "static", "static"]
    assert losses[-1] < losses[0], losses
    assert torch.equal(state.model.pos_embed, pos0)
    assert not state.model.pos_embed.requires_grad


def test_nan_abort_via_device_flag():
    """A non-finite loss aborts with FloatingPointError at the next check,
    and at the epoch's end when no check interval fires."""
    cfg = _cfg()
    tc = _tc(epochs=1, warmup_epochs=0, base_keep_rate=1.0)
    mod = train.TrainModule(cfg, tc, "ce", iters_per_epoch=2, device="cpu")
    batches = _batches(cfg, 2, 4, seed=1)
    bad = batches[0][0].copy()
    bad[0, 0, 0, 0] = np.nan
    with pytest.raises(FloatingPointError):
        mod.train_epoch(mod.init(), [(bad, batches[0][1])] + batches[1:], 0,
                        nan_check_every=1)
    with pytest.raises(FloatingPointError):
        mod.train_epoch(mod.init(), [(bad, batches[0][1])], 0, nan_check_every=0)


def test_log_points_report_window_means():
    cfg = _cfg()
    tc = _tc(epochs=1, warmup_epochs=0, base_keep_rate=1.0)
    mod = train.TrainModule(cfg, tc, "ce", iters_per_epoch=4, device="cpu")
    lines = []
    state, stats = mod.train_epoch(mod.init(), _batches(cfg, 4, 4, seed=2), 0,
                                   log_every=2, log_fn=lines.append)
    assert len(lines) == 2 and all("loss:" in ln for ln in lines)
    assert math.isfinite(stats["loss"]) and state.step == 4


def test_engine_refuses_what_is_not_ported():
    cfg = _cfg()
    with pytest.raises(ValueError, match="anneal_mode"):
        train.TrainModule(cfg, _tc(anneal_mode="linear"), "ce", 2, device="cpu")
    with pytest.raises(ValueError, match="drop_loc"):
        train.TrainModule(cfg, _tc(drop_loc=(2,)), "ce", 2, device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        train.TrainModule(cfg, _tc(optimizer="sgd"), "ce", 2,
                          device="cpu").init()


def test_profile_train_help_needs_cuda_and_its_steps_run():
    """The train-step profiler is a card-only tool: it answers --help and
    refuses to run without CUDA.  Its five step variants run through
    train_step on the CPU at a small size, on its synthetic batches, with
    finite losses."""
    import contextlib
    import io

    from tpat_tpu_torch.cli import profile_train

    buf = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stdout(buf):
        profile_train.cli(["--help"])
    assert exc.value.code == 0 and "--out" in buf.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            profile_train.cli([])
    cfg = _cfg(base_keep_rate=0.7)
    mod = train.TrainModule(cfg, _tc(base_keep_rate=0.7), "ce", 2,
                            device="cpu")
    state = mod.init()
    acc = mod._zero_acc()
    (x, y), = profile_train.synthetic_batches(cfg, 2, 1, seed=4, device="cpu")
    assert x.shape == (2, 1, cfg.target_length, cfg.num_mel_bins)
    assert y.shape == (2, cfg.num_classes)
    variants = profile_train.step_variants(cfg)
    assert list(variants) == [
        "dense_mask2d", "dense", "hybrid_0.8", "hybrid_0.9", "static"]
    for kw in variants.values():
        mod.train_step(state, acc, x, y, **kw)
    assert state.step == 5 and bool(acc["finite"])
