"""The port's fused LayerNorm (tpat_tpu_torch.ops.layernorm, B4) and the
model's ``use_fused_layernorm`` path against the JAX package, on the CPU.

The op is held against ``tpat_tpu.ops.pallas_layernorm.fused_layernorm``,
whose Pallas kernels run in interpret mode off the TPU, and against its
``jax.vjp``; the port's autograd Function runs its plain forward and
backward on CPU tensors.  At model level the JAX ``FusedLayerNorm`` takes
its plain LayerNorm off the TPU (``vit.py:149-156``), so these tests hold
the port's dispatch and the Function's backward against JAX: logits,
parameter gradients and a short ``train_epoch`` trajectory."""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import TrainConfig, ViTConfig
from tpat_tpu.engine import schedules as jschedules
from tpat_tpu.engine import train as jtrain
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu.ops import pallas_layernorm as jln
from tpat_tpu_torch.engine import train
from tpat_tpu_torch.models.vit import AudioViT, FusedLayerNorm, LayerNorm
from tpat_tpu_torch.ops import layernorm as ln
from tpat_tpu_torch.utils.weights import jax_flat_grads, state_dict_from_jax

EPS = 1e-6


def _operands(m, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, d)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(d,))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(d,))).astype(np.float32)
    dy = rng.normal(size=(m, d)).astype(np.float32)
    return x, scale, bias, dy


def _both(x, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(x).astype(dtype)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


@pytest.mark.parametrize("m,d", [(8, 128), (515, 256), (1024, 768)])
def test_forward_matches_jax(m, d):
    """y against the Pallas kernel (interpret mode): atol 2e-5 (f32, sums
    over D in another order); mu and rstd of the plain forward against the
    kernel's ``_fwd_impl``: rtol 1e-5 / atol 1e-6."""
    x, scale, bias, _ = _operands(m, d, seed=m)
    want = jln.fused_layernorm(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias), EPS)
    got = ln.fused_layernorm(*map(torch.from_numpy, (x, scale, bias)), EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    _, wmu, wrstd = jln._fwd_impl(jnp.asarray(x), jnp.asarray(scale),
                                  jnp.asarray(bias), EPS)
    y, mu, rstd = ln.layernorm_fwd_plain(
        *map(torch.from_numpy, (x, scale, bias)), EPS)
    assert mu.shape == rstd.shape == (m, 1) and mu.dtype == torch.float32
    np.testing.assert_allclose(mu.numpy(), np.asarray(wmu)[:m], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(wrstd)[:m], rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(y, got)
    assert ln.launches == 0


def test_3d_bf16_matches_jax():
    """(2, 17, 128) bf16: y in bf16 of x's shape, within one bf16 ulp of the
    Pallas kernel's (atol = rtol = 1e-2: the f32 values may round to
    neighbouring bf16 values)."""
    x, scale, bias, _ = _operands(34, 128, seed=3)
    jx, tx = _both(x.reshape(2, 17, 128), jnp.bfloat16)
    want = jln.fused_layernorm(jx, jnp.asarray(scale), jnp.asarray(bias), EPS)
    got = ln.fused_layernorm(tx, torch.from_numpy(scale), torch.from_numpy(bias), EPS)
    assert got.shape == (2, 17, 128) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_jax(dtype):
    """dx, dscale and dbias at (130, 256), not a multiple of the JAX
    kernel's 512-row tile, against ``jax.vjp``: each within 1e-5 of the
    tensor's largest |entry| (f32 sums over rows and columns in another
    order), dx in bf16 within 2e-2 of it (one bf16 ulp)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x, scale, bias, dy = _operands(130, 256, seed=7)
    jx, tx = _both(x, jdt)
    jdy, tdy = _both(dy, jdt)
    _, vjp = jax.vjp(lambda a, s, b: jln.fused_layernorm(a, s, b, EPS),
                     jx, jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jdy)
    w, b = (torch.from_numpy(v).requires_grad_() for v in (scale, bias))
    tx.requires_grad_()
    y = ln.fused_layernorm(tx, w, b, EPS)
    assert y.grad_fn.name() == "_FusedLayerNormBackward"
    got = torch.autograd.grad(y, (tx, w, b), tdy)
    for name, g, wv in zip(("dx", "dscale", "dbias"), got, want):
        wv = np.asarray(wv.astype(jnp.float32))
        assert g.dtype == (tx.dtype if name == "dx" else torch.float32)
        rel = 2e-2 if (name == "dx" and dtype == "bfloat16") else 1e-5
        err = np.abs(g.float().numpy() - wv).max()
        assert err <= rel * np.abs(wv).max(), (name, err)
    assert ln.launches == ln.bwd_launches == 0


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """The launchers check width, dtype, contiguity and device before they
    build anything: a CPU tensor never reaches nvcc."""
    w = torch.ones(768)
    with pytest.raises(ValueError, match="width 100"):
        ln._forward_kernel(torch.zeros(3, 100), torch.ones(100), torch.zeros(100), EPS)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln._forward_kernel(torch.zeros(3, 768, dtype=torch.float16), w, w, EPS)
    with pytest.raises(ValueError, match="contiguous"):
        ln._forward_kernel(torch.zeros(3, 1536)[:, ::2], w, w, EPS)
    with pytest.raises(ValueError, match="device cpu"):
        ln._forward_kernel(torch.zeros(3, 768), w, w, EPS)
    with pytest.raises(ValueError, match="device cpu"):
        ln._backward_kernel(torch.zeros(3, 768), w, torch.zeros(3, 1),
                            torch.ones(3, 1), torch.zeros(3, 768))
    with pytest.raises(ValueError, match="scale and bias"):
        ln.fused_layernorm(torch.zeros(2, 768), torch.ones(384), torch.zeros(768))
    assert ln.supports(768) == jln.supports(768) and not ln.supports(192)
    assert set(ln.WIDTHS) >= {192, 384, 768, 1024, 1280}
    assert ln.launches == ln.bwd_launches == 0


# --- model level --------------------------------------------------------

def _cfg(**kw):
    base = dict(
        compute_dtype="float32", embed_dim=128, depth=4, num_heads=2,
        num_classes=5, target_length=128, num_mel_bins=32, drop_loc=(1, 3),
        base_keep_rate=0.7, drop_path_rate=0.0, use_fused_layernorm=True,
    )
    base.update(kw)
    return ViTConfig(**base)


def _sharpened(cfg, seed=0):
    # the param tree depends on neither attention_impl nor the LN flag
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


@pytest.fixture(scope="module")
def weights():
    params = _sharpened(_cfg())
    x = np.random.default_rng(6).normal(size=(3, 1, 128, 32)).astype(np.float32)
    return params, x


def _port(cfg, params):
    model = AudioViT(cfg)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model.eval()


def _hybrid_args(cfg, exact=0.61):
    rates = tuple(exact if i in cfg.drop_loc else 1.0 for i in range(cfg.depth))
    bucket = jschedules.bucket_keep_rates(rates, base_keep_rate=cfg.base_keep_rate)
    nl = jschedules.masked_kept_counts(rates, cfg.drop_loc, cfg.num_patches)
    return rates, bucket, nl


def test_blocks_take_fused_layernorm_and_pth_round_trips(weights):
    """With the flag every norm1/norm2 is a FusedLayerNorm and fc_norm the
    plain LayerNorm; the state dict has the flag-off model's keys, and a
    .pth saved by either loads strictly into the other with equal logits
    (rtol 1e-6: the same math)."""
    params, x = weights
    on = _port(_cfg(), params)
    off = _port(_cfg(use_fused_layernorm=False), params)
    for blk in on.blocks:
        assert type(blk.norm1) is FusedLayerNorm and type(blk.norm2) is FusedLayerNorm
    assert type(on.fc_norm) is LayerNorm and type(off.blocks[0].norm1) is LayerNorm
    assert list(on.state_dict()) == list(off.state_dict())
    for src, dst_cfg in ((on, _cfg(use_fused_layernorm=False)), (off, _cfg())):
        buf = io.BytesIO()
        torch.save({"model": src.state_dict()}, buf)
        buf.seek(0)
        dst = AudioViT(dst_cfg)
        dst.load_state_dict(torch.load(buf)["model"], strict=True)
        with torch.no_grad():
            a = src(torch.from_numpy(x))
            b = dst.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("path", ["static", "hybrid"])
def test_logits_match_jax(weights, path):
    """Logits with use_fused_layernorm in both packages: static rtol 1e-3 /
    atol 2e-4 (test_torch_model's tolerance), hybrid rtol 2e-3 / atol 1e-4
    (test_torch_hybrid's)."""
    params, x = weights
    cfg = _cfg()
    jmodel = JaxAudioViT(cfg)
    model = _port(cfg, params)
    xt = torch.from_numpy(x)
    if path == "static":
        want = jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(
            params, jnp.asarray(x))
        with torch.no_grad():
            got = model(xt)
        tol = dict(rtol=1e-3, atol=2e-4)
    else:
        rates, bucket, nl = _hybrid_args(cfg)
        want = jax.jit(lambda p, v: jmodel.apply(
            {"params": p}, v, jnp.asarray(rates, jnp.float32),
            num_left_array=jnp.asarray(nl, jnp.int32), bucket_rates=bucket,
            method=JaxAudioViT.forward_hybrid))(params, jnp.asarray(x))
        with torch.no_grad():
            got = model.forward_hybrid(xt, rates, num_left=nl, bucket_rates=bucket)
        tol = dict(rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def _ce(logits, y):
    return -(y * jax.nn.log_softmax(logits, axis=-1)).sum(-1).mean()


@pytest.mark.parametrize("path", ["static", "hybrid"])
def test_param_gradients_match_jax(weights, path, monkeypatch):
    """Gradients of the soft-target CE with respect to every parameter,
    autograd through the LayerNorm Function (its plain backward ran once per
    norm1/norm2) vs jax.grad: per tensor within 1e-4 of its largest
    |gradient|, the loss within rtol 1e-5 (test_torch_hybrid's
    tolerances)."""
    params, x = weights
    cfg = _cfg()
    y = np.eye(cfg.num_classes, dtype=np.float32)[[0, 3, 1]]
    rates, bucket, nl = _hybrid_args(cfg)
    jmodel = JaxAudioViT(cfg)

    def jloss(p):
        if path == "static":
            logits = jmodel.apply({"params": p}, jnp.asarray(x))
        else:
            logits = jmodel.apply(
                {"params": p}, jnp.asarray(x), jnp.asarray(rates, jnp.float32),
                num_left_array=jnp.asarray(nl, jnp.int32), bucket_rates=bucket,
                method=JaxAudioViT.forward_hybrid)
        return _ce(logits, jnp.asarray(y))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path_): np.asarray(v)
            for path_, v in jax.tree_util.tree_flatten_with_path(want)[0]}

    backward_calls = []
    plain_bwd = ln.layernorm_bwd_plain
    monkeypatch.setattr(ln, "layernorm_bwd_plain",
                        lambda *a: backward_calls.append(a[0].shape) or plain_bwd(*a))
    model = _port(cfg, params)
    xt = torch.from_numpy(x)
    logits = (model(xt) if path == "static" else
              model.forward_hybrid(xt, rates, num_left=nl, bucket_rates=bucket))
    loss = -(torch.from_numpy(y) * torch.log_softmax(logits, -1)).sum(-1).mean()
    named = {k: p for k, p in model.named_parameters() if p.requires_grad}
    grads = torch.autograd.grad(loss, list(named.values()))
    assert len(backward_calls) == 2 * cfg.depth
    got = jax_flat_grads(dict(zip(named, grads)))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want) - {"pos_embed"}
    for k, g in got.items():
        scale = np.abs(want[k]).max()
        assert np.abs(g - want[k]).max() <= 1e-4 * scale + 1e-9, k


def test_train_epoch_matches_jax():
    """Four epochs (dense, anneal at rates 1.0, hybrid anneal, static), two
    steps each, with use_fused_layernorm in both engines, f32: the phases
    equal and per-epoch loss and grad norm within rtol 1e-4
    (test_torch_train's tolerance)."""
    cfg = _cfg(depth=3, drop_loc=(1, 2), base_keep_rate=0.5)
    tc = TrainConfig(
        batch_size=4, epochs=4, blr=1e-3, min_lr=1e-5, warmup_epochs=1,
        base_keep_rate=0.5, drop_loc=(1, 2), shrink_start_epoch=1,
        shrink_epochs=2, anneal_mode="hybrid", anneal_buckets=4,
    )
    params = _sharpened(cfg)
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(2):
        y_idx = rng.integers(0, cfg.num_classes, size=4)
        xb = rng.normal(size=(4, 1, cfg.target_length, cfg.num_mel_bins))
        xb[np.arange(4), 0, 0, 0] = y_idx * 2.0
        batches.append((xb.astype(np.float32),
                        np.eye(cfg.num_classes, dtype=np.float32)[y_idx]))
    jcfg = dataclasses.replace(cfg, attention_impl="xla")
    jmod = jtrain.TrainModule(model=JaxAudioViT(jcfg), model_cfg=jcfg,
                              train_cfg=tc, loss_type="ce", iters_per_epoch=2)
    jstate = jmod.load(params)
    mod = train.TrainModule(cfg, tc, "ce", iters_per_epoch=2, device="cpu")
    state = mod.load(state_dict_from_jax(params))
    assert type(state.model.blocks[0].norm1) is FusedLayerNorm
    for epoch in range(4):
        jstate, want = jmod.train_epoch(jstate, batches, epoch)
        state, got = mod.train_epoch(state, batches, epoch)
        assert got["phase"] == want["phase"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    assert got["phase"] == "static" and ln.launches == ln.bwd_launches == 0
