"""The AST training recipe of the port (engine/optimizer.py's
make_ast_optimizer and make_ast_lr_fn, TrainModule with optimizer
'ast_adam' and custom_rank) against the JAX package's optax chain, lr
table and TrainModule, on the CPU; the lr table also against the
reference's own torch loop (Adam, MultiStepLR and the 50-step warmup
writes).  Mirrors tests/test_ast_recipe.py."""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import TrainConfig, ViTConfig
from tpat_tpu.engine import optimizer as jopt
from tpat_tpu.engine import train as jtrain
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu_torch.engine import optimizer as opt
from tpat_tpu_torch.engine import train
from tpat_tpu_torch.utils.weights import state_dict_from_jax


def _tc(**kw):
    base = dict(optimizer="ast_adam", lr=1e-3, warmup=True,
                lrscheduler_start=2, lrscheduler_step=1, lrscheduler_decay=0.5,
                epochs=5, epoch_base=1)
    base.update(kw)
    return TrainConfig(**base)


LR_CASES = [
    # the small-recipe regime: warmup spans milestone epochs
    dict(iters=33, tc=dict(lr=1e-3, lrscheduler_start=5, lrscheduler_decay=0.85,
                           epochs=40)),
    dict(iters=7, tc=dict(warmup=False, lrscheduler_start=2, epochs=12)),
    dict(iters=500, tc=dict(lrscheduler_start=3, epochs=4)),
    dict(iters=5, tc=dict(warmup=False, lrscheduler_start=1, lrscheduler_step=3,
                          epochs=9, epoch_base=0)),
]


@pytest.mark.parametrize("accum", [1, 4])
@pytest.mark.parametrize("case", LR_CASES)
def test_ast_lr_table_matches_jax(case, accum):
    """Update index -> lr against tpat_tpu's make_ast_lr_fn at every update
    of the run and two past its end (held at the last entry): within f32
    rounding, JAX's table being f32."""
    tc = _tc(**case["tc"])
    got = opt.make_ast_lr_fn(tc, case["iters"], accum=accum)
    want = jopt.make_ast_lr_fn(tc, case["iters"], accum=accum)
    n = tc.epochs * case["iters"] // accum + 2
    np.testing.assert_allclose(
        [got(u) for u in range(n)],
        [float(want(jnp.asarray(u))) for u in range(n)], rtol=1e-6, atol=0)


def test_ast_lr_warmup_milestone_overlap_torch_oracle():
    """The reference's loop in torch (traintest.py:95, 160-164, 249): a
    milestone decay that fires during the warmup is overwritten by the next
    50-step write.  The port's table equals it entry for entry."""
    base, gamma, iters, n_epochs, start = 1e-3, 0.85, 33, 40, 5
    p = torch.nn.Parameter(torch.zeros(1))
    adam = torch.optim.Adam([p], lr=base)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        adam, list(range(start, 1000, 1)), gamma=gamma)
    want, gstep = [], 0
    for _epoch in range(1, n_epochs + 1):
        for _ in range(iters):
            if gstep <= 1000 and gstep % 50 == 0:
                for g in adam.param_groups:
                    g["lr"] = gstep / 1000 * base
            want.append(adam.param_groups[0]["lr"])
            gstep += 1
        adam.step()  # no gradient: only keeps the scheduler order
        sched.step()
    lr_fn = opt.make_ast_lr_fn(
        _tc(lr=base, lrscheduler_start=start, lrscheduler_decay=gamma,
            epochs=n_epochs), iters)
    np.testing.assert_allclose([lr_fn(s) for s in range(iters * n_epochs)],
                               want, rtol=1e-12, atol=0)


def test_ast_lr_accum_counts_micro_batches():
    """Update u reads the lr of its last micro-batch, not a schedule
    stretched by accum."""
    tc = _tc(lrscheduler_start=3)
    micro = opt.make_ast_lr_fn(tc, 500)
    upd = opt.make_ast_lr_fn(tc, 500, accum=4)
    for u in (0, 10, 100, 300, 499):
        assert upd(u) == micro(4 * u + 3), u
    assert micro(0) == 0.0 and micro(100) == pytest.approx(1e-4, rel=1e-12)
    assert micro(1600) == pytest.approx(0.5e-3, rel=1e-12)  # epoch 4


class _Two(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w.copy()))
        self.b = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("wd", [5e-7, 1e-2])
def test_ast_adam_matches_the_optax_chain(wd):
    """Six updates of make_ast_optimizer with the lr table (decayed at the
    end of epochs 1 and 2) vs tpat_tpu's add_decayed_weights ->
    scale_by_adam -> schedule chain on the same gradients: every parameter
    within rtol 1e-5.  The decay is coupled: at wd 1e-2 AdamW lands
    elsewhere."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    b0 = rng.normal(size=(3,)).astype(np.float32)
    grads = [(rng.normal(size=(4, 3)).astype(np.float32),
              rng.normal(size=(3,)).astype(np.float32)) for _ in range(6)]
    tc = _tc(lr=1e-2, ast_weight_decay=wd, warmup=False, lrscheduler_start=1,
             epochs=3)
    module = _Two(w0, b0)
    adam = opt.make_ast_optimizer(module, tc)
    lr_fn = opt.make_ast_lr_fn(tc, iters_per_epoch=2)
    jlr = jopt.make_ast_lr_fn(tc, iters_per_epoch=2)
    tx = jopt.make_ast_optimizer(tc, jlr)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = tx.init(params)
    adamw = torch.optim.AdamW([torch.nn.Parameter(torch.from_numpy(w0.copy()))],
                              lr=0.0, betas=(0.95, 0.999), eps=1e-8,
                              weight_decay=wd)
    for u, (gw, gb) in enumerate(grads):
        module.w.grad, module.b.grad = torch.from_numpy(gw), torch.from_numpy(gb)
        opt.set_lr(adam, lr_fn(u))
        adam.step()
        adamw.param_groups[0]["params"][0].grad = torch.from_numpy(gw)
        adamw.param_groups[0]["lr"] = lr_fn(u)
        adamw.step()
        updates, state = tx.update({"w": jnp.asarray(gw), "b": jnp.asarray(gb)},
                                   state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(module.w.detach().numpy(),
                                   np.asarray(params["w"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(module.b.detach().numpy(),
                                   np.asarray(params["b"]), rtol=1e-5, atol=1e-7)
    assert np.abs(module.w.detach().numpy() - w0).max() > 1e-2  # it moved
    decoupled = adamw.param_groups[0]["params"][0].detach().numpy()
    assert (np.abs(decoupled - module.w.detach().numpy()).max() > 1e-6) == (wd > 1e-3)
    assert len(adam.param_groups) == 1 and adam.param_groups[0]["lr_scale"] == 1.0


def test_hard_cross_entropy_matches_torch():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 9)).astype(np.float32)
    onehot = np.eye(9, dtype=np.float32)[rng.integers(0, 9, size=6)]
    got = train.hard_cross_entropy(torch.from_numpy(logits), torch.from_numpy(onehot))
    want = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(onehot).argmax(1))
    assert abs(got.item() - want.item()) < 1e-6


# --- TrainModule with the AST recipe -------------------------------------

def _cfg(**kw):
    base = dict(
        compute_dtype="float32", embed_dim=128, depth=3, num_heads=2,
        num_classes=5, target_length=128, num_mel_bins=32, drop_loc=(1, 2),
        base_keep_rate=0.5, drop_path_rate=0.0, num_extra_tokens=2,
        importance="cls", pooling="cls_dist", pos_embed_mode="post_cat",
        use_final_norm=True, frozen_pos_embed=False,
    )
    base.update(kw)
    return ViTConfig(**base)


def _sharpened(cfg):
    init = JaxAudioViT(dataclasses.replace(cfg, attention_impl="xla")).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 1, 32, 128)))["params"]
    rng = np.random.default_rng(1)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        return (rng.normal(size=np.shape(leaf)) * (1.0 if "qkv" in name else 0.05)
                ).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, init)


def _batches(n, b, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y_idx = rng.integers(0, 5, size=b)
        x = rng.normal(size=(b, 1, 32, 128))
        x[np.arange(b), 0, 0, 0] = y_idx * 2.0
        out.append((x.astype(np.float32), np.eye(5, dtype=np.float32)[y_idx]))
    return out


def _runs(cfg, tc, params, batches, epochs, custom_rank=None):
    jmod = jtrain.TrainModule(
        model=JaxAudioViT(dataclasses.replace(cfg, attention_impl="xla")),
        model_cfg=dataclasses.replace(cfg, attention_impl="xla"), train_cfg=tc,
        loss_type="ce_hard", iters_per_epoch=len(batches),
        custom_rank=custom_rank)
    mod = train.TrainModule(cfg, tc, "ce_hard", iters_per_epoch=len(batches),
                            device="cpu", custom_rank=custom_rank)
    jstate, state = jmod.load(params), mod.load(state_dict_from_jax(params))
    want, got = [], []
    for epoch in epochs:
        jstate, stats = jmod.train_epoch(jstate, batches, epoch)
        want.append(stats)
        state, stats = mod.train_epoch(state, batches, epoch)
        got.append(stats)
    return got, want, state


def test_ast_adam_epochs_match_jax():
    """run_ast's schedule: epochs counted from 1 (epoch_base 1, epochs =
    n + 1), keep rates per epoch, MultiStepLR from epoch 2: dense, anneal
    at rates 1.0,
    anneal at 0.75 (hybrid), static, two steps each from the same weights
    and batches, f32: the phases equal and per-epoch loss and grad norm
    within rtol 1e-4; every parameter moved, pos_embed included."""
    cfg = _cfg()
    tc = _tc(batch_size=4, epochs=5, base_keep_rate=0.5, drop_loc=(1, 2),
             shrink_start_epoch=2, shrink_epochs=2, warmup=False,
             lrscheduler_start=2, keep_rate_iter_mode="per_epoch")
    params = _sharpened(cfg)
    got, want, state = _runs(cfg, tc, params, _batches(2, 4, 3), range(1, 5))
    assert [s["phase"] for s in got] == [s["phase"] for s in want] == [
        "dense", "anneal", "anneal", "static"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    start = state_dict_from_jax(params)
    for k, v in state.model.state_dict().items():
        assert not torch.equal(v, start[k]), k


def test_custom_rank_static_epochs_match_jax():
    """custom_rank 'mean' in the static phase through both engines: loss
    and grad norm within rtol 1e-4; an anneal epoch refuses it in both."""
    cfg = _cfg()
    tc = _tc(batch_size=4, epochs=3, base_keep_rate=0.5, drop_loc=(1, 2),
             shrink_start_epoch=0, shrink_epochs=1, warmup=False,
             lrscheduler_start=9)
    params = _sharpened(cfg)
    got, want, _ = _runs(cfg, tc, params, _batches(2, 4, 5), range(1, 3),
                         custom_rank="mean")
    assert [s["phase"] for s in got] == ["static", "static"]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
    anneal = dataclasses.replace(tc, shrink_start_epoch=1, shrink_epochs=5)
    for mode in ("hybrid", "masked"):
        mod = train.TrainModule(cfg, dataclasses.replace(anneal, anneal_mode=mode),
                                "ce_hard", 2, device="cpu", custom_rank="mean")
        with pytest.raises(AssertionError, match="static-phase only"):
            mod.train_epoch(mod.load(state_dict_from_jax(params)),
                            _batches(1, 4, 5), 2)
