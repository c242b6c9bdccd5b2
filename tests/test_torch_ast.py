"""The port's AST flavour (tpat_tpu_torch.models.vit.AudioViT with 2 extra
tokens, CLS-row importance, a final norm and cls_dist pooling), its
reference-checkpoint importers and the custom-rank and intensity-band
ablations, against the JAX package on the CPU.

Weights are JAX params drawn from numpy with sharpened qkv (N(0, 1); the
rest N(0, 0.05^2)) and carried across by ``state_dict_from_jax``, so the
top-k choices are well separated across frameworks.  The JAX model runs
attention_impl 'fused' (its Pallas kernels in interpret mode, under jit)
and the port the same setting, whose kernel wrappers run their plain
versions on CPU tensors."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import ViTConfig, ast_vit_base as jax_ast_vit_base
from tpat_tpu.engine import evaluate as jevaluate
from tpat_tpu.engine import schedules as jschedules
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu.models.vit import patch_stats as jpatch_stats
from tpat_tpu.utils import torch_export as jexport
from tpat_tpu.utils import torch_import as jti
from tpat_tpu_torch.config import ast_vit_base
from tpat_tpu_torch.engine import evaluate
from tpat_tpu_torch.engine import schedules
from tpat_tpu_torch.models.vit import AudioViT, patch_stats
from tpat_tpu_torch.ops import qkv_attention as qa
from tpat_tpu_torch.utils import torch_import as ti
from tpat_tpu_torch.utils.weights import (
    ast_state_dict,
    jax_flat_from_state_dict,
    jax_flat_grads,
    state_dict_from_jax,
    state_dict_of,
)
from tests.test_reference_layout import (
    _fake_ast_timm_state_dict,
    _fake_deit_state_dict,
)

# the AST input is (B, 1, mel bins, frames): a (4, 8) patch grid, N = 34
MEL, FRAMES = 64, 128
ATOL = 1e-5  # f32 logits, the same math summed in another order


def _cfg(**kw):
    base = dict(
        compute_dtype="float32", embed_dim=128, depth=4, num_heads=2,
        num_classes=7, target_length=FRAMES, num_mel_bins=MEL,
        num_extra_tokens=2, importance="cls", pooling="cls_dist",
        pos_embed_mode="post_cat", use_final_norm=True,
        frozen_pos_embed=False, drop_path_rate=0.0, drop_loc=(1, 3),
        base_keep_rate=0.6, attention_impl="fused",
    )
    base.update(kw)
    return ViTConfig(**base)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _sharpened(cfg, seed=0):
    init = JaxAudioViT(dataclasses.replace(cfg, attention_impl="xla")).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 1, MEL, FRAMES))
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
    x = np.random.default_rng(6).normal(size=(3, 1, MEL, FRAMES)).astype(np.float32)
    return params, x


def _port(cfg, params):
    model = AudioViT(cfg)
    model.load_state_dict(state_dict_from_jax(params, flavor="ast"), strict=True)
    return model.eval()


def _topk(feats):
    return {k: np.asarray(v) for k, v in feats.items() if k.endswith("topk_idx")}


@pytest.mark.parametrize("keep", [1.0, 0.6])
def test_static_forward_matches_jax(weights, keep):
    """The static forward vs tpat_tpu's: logits atol 1e-5, every drop
    block's top-k indices equal, and the CLS-row scores of each block."""
    params, x = weights
    cfg = _cfg(base_keep_rate=keep)
    jmodel = JaxAudioViT(cfg)
    want, wfeats = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, extract_features=True))(params, jnp.asarray(x))
    with torch.no_grad():
        got, gfeats = _port(cfg, params)(torch.from_numpy(x),
                                         extract_features=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert _topk(gfeats).keys() == _topk(wfeats).keys()
    assert len(_topk(gfeats)) == (2 if keep < 1.0 else 0)
    for k, v in _topk(wfeats).items():
        np.testing.assert_array_equal(gfeats[k].numpy(), v, err_msg=k)
    for i in range(cfg.depth):
        np.testing.assert_allclose(
            gfeats[f"block-{i}.attn_score"].numpy(),
            np.asarray(wfeats[f"block-{i}.attn_score"]), rtol=1e-3, atol=1e-6)


def _anneal_args(cfg, exact):
    rates = tuple(exact if i in cfg.drop_loc else 1.0 for i in range(cfg.depth))
    bucket = jschedules.bucket_keep_rates(rates, base_keep_rate=cfg.base_keep_rate)
    nl = jschedules.masked_kept_counts(rates, cfg.drop_loc, cfg.num_patches)
    return rates, bucket, nl


def test_masked_and_hybrid_forwards_match_jax(weights):
    """forward_masked and forward_hybrid at a mid-anneal rate (0.77, bucket
    0.8) vs JAX's: logits atol 1e-5."""
    params, x = weights
    cfg = _cfg()
    rates, bucket, nl = _anneal_args(cfg, 0.77)
    jmodel = JaxAudioViT(cfg)
    kr, nla = jnp.asarray(rates, jnp.float32), jnp.asarray(nl, jnp.int32)
    want_m = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, kr, num_left_array=nla,
        method=JaxAudioViT.forward_masked))(params, jnp.asarray(x))
    want_h = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, kr, num_left_array=nla, bucket_rates=bucket,
        method=JaxAudioViT.forward_hybrid))(params, jnp.asarray(x))
    model = _port(cfg, params)
    with torch.no_grad():
        got_m = model.forward_masked(torch.from_numpy(x), rates, num_left=nl)
        got_h = model.forward_hybrid(torch.from_numpy(x), rates, num_left=nl,
                                     bucket_rates=bucket)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=ATOL)
    assert qa.launches == qa.prefix_launches == 0  # CPU tensors: plain only


def test_hybrid_param_gradients_match_jax(weights):
    """Gradients of the hard CE loss through one hybrid forward with respect
    to every parameter (pos_embed and both tokens learnable), port vs
    jax.grad through the Pallas custom VJPs: per tensor within 1e-4 of its
    largest |gradient|."""
    params, x = weights
    cfg = _cfg()
    y = np.array([0, 3, 6])
    rates, bucket, nl = _anneal_args(cfg, 0.77)
    jmodel = JaxAudioViT(cfg)

    def jloss(p):
        logits = jmodel.apply(
            {"params": p}, jnp.asarray(x), jnp.asarray(rates, jnp.float32),
            num_left_array=jnp.asarray(nl, jnp.int32), bucket_rates=bucket,
            method=JaxAudioViT.forward_hybrid)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1).mean()

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(params)
    want = _flat(want)
    model = _port(cfg, params)
    logits = model.forward_hybrid(torch.from_numpy(x), rates, num_left=nl,
                                  bucket_rates=bucket)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y))
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    got = jax_flat_grads(dict(zip(named, grads)))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert set(got) == set(want)
    for k in ("pos_embed", "dist_token", "mlp_head/kernel", "norm/scale"):
        assert np.any(got[k]), k
    for k, g in got.items():
        scale = max(np.abs(want[k]).max(), 1e-12)
        assert np.abs(g - want[k]).max() <= 1e-4 * scale, k


def test_mlp_head_torch_default_init_and_param_names(weights):
    """ast_models.py:290's plain nn.Linear head: weight and bias within
    U(+-1/sqrt(fan_in)), reaching near the bound (as
    test_ast_mlp_head_torch_default_init holds the JAX init); the tokens
    and the pos embed trunc-normal(0.02) and learnable; the state dict's
    keys are the reference .pth's without its module.v./module. prefixes
    and equal state_dict_from_jax's for the same flavour."""
    cfg = _cfg(embed_dim=64, num_classes=35)
    model = AudioViT(cfg, generator=torch.Generator().manual_seed(3))
    w, b = model.mlp_head[1].weight, model.mlp_head[1].bias
    bound = 1.0 / np.sqrt(64)
    assert w.abs().max() <= bound * 1.0001 and w.abs().max() >= bound * 0.85
    assert b.abs().max() <= bound * 1.0001 and b.abs().max() > 0
    for p in (model.cls_token, model.dist_token, model.pos_embed):
        assert p.requires_grad and 0 < p.abs().max() <= 0.04 + 1e-7
    assert torch.equal(model.mlp_head[0].weight, torch.ones(64))
    params, _ = weights
    model = AudioViT(_cfg())
    assert set(model.state_dict()) == set(state_dict_from_jax(params))
    ref = {k.removeprefix("module.").removeprefix("v.")
           for k in jexport.ast_state_dict(params)}
    assert set(model.state_dict()) == ref


def test_ast_state_dict_matches_the_jax_exporter(weights):
    """ast_state_dict (the port's copy) vs tpat_tpu's torch_export, entry
    for entry, and jax_flat_from_state_dict inverts state_dict_from_jax
    on the AST tree."""
    params, _ = weights
    got, want = ast_state_dict(params), jexport.ast_state_dict(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    flat = jax_flat_from_state_dict(state_dict_from_jax(params))
    ref = _flat(params)
    assert flat.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(flat[k], ref[k], err_msg=k)


def _imported_flat(imported):
    return jax_flat_from_state_dict(
        {k: torch.as_tensor(v) for k, v in imported.items()})


@pytest.mark.parametrize("nc", [35, 50])
def test_ast_importer_matches_jax(tmp_path, nc):
    """ast_state_dict_for vs ast_params_from_state_dict on a fake AST
    DataParallel .pth (module.v. trunk, module.mlp_head, (8, 64) pos grid),
    read through torch.save/load: every entry equal, the time axis
    centre-cropped to 32 frames, the head kept only at the checkpoint's
    class count (35)."""
    sd_np = _fake_ast_timm_state_dict(np.random.default_rng(7), depth=2, d=64,
                                      nc=35)
    path = tmp_path / "ast.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd_np.items()}, path)
    cfg = _cfg(embed_dim=64, depth=2, num_classes=nc, target_length=512,
               num_mel_bins=128, drop_loc=(1,))
    got = _imported_flat(ti.ast_state_dict_for(
        state_dict_of(torch.load(path, weights_only=True)), cfg))
    want = _flat(jti.ast_params_from_state_dict(
        jti.load_torch_state_dict(str(path)), cfg))
    assert got.keys() == want.keys()
    assert ("mlp_head/kernel" in got) == (nc == 35)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["pos_embed"].shape == (1, 2 + 8 * 32, 64)
    model = AudioViT(cfg)
    ti.overlay_state_dict(model, ti.ast_state_dict_for(
        state_dict_of(torch.load(path, weights_only=True)), cfg))
    bad = dataclasses.replace(cfg, num_mel_bins=64)
    with pytest.raises(ValueError, match="pos_embed rows"):
        ti.ast_state_dict_for(state_dict_of(torch.load(path, weights_only=True)),
                              bad)


@pytest.mark.parametrize("tl", [256, 512])
def test_deit_importer_matches_jax(tl):
    """deit_state_dict_for vs deit_params_from_state_dict on a fake timm
    DeiT-distilled state dict (RGB conv, 24 x 24 pos grid, two heads): the
    conv summed to one channel, the grid cut (16 frames) or stretched (32),
    no head; every entry equal."""
    sd_np = _fake_deit_state_dict(np.random.default_rng(3), depth=2, d=64)
    cfg = _cfg(embed_dim=64, depth=2, target_length=tl, num_mel_bins=128,
               drop_loc=(1,))
    got = _imported_flat(ti.deit_state_dict_for(
        {k: torch.from_numpy(v) for k, v in sd_np.items()}, cfg))
    want = _flat(jti.deit_params_from_state_dict(sd_np, cfg))
    assert got.keys() == want.keys()
    assert not any(k.startswith(("head", "mlp_head")) for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert got["patch_embed/proj/kernel"].shape[2] == 1


def test_patch_stats_match_jax(weights):
    _, x = weights
    for kind in ("mean", "std"):
        np.testing.assert_allclose(
            patch_stats(torch.from_numpy(x), 16, kind).numpy(),
            np.asarray(jpatch_stats(jnp.asarray(x), 16, kind)),
            rtol=1e-5, atol=1e-6, err_msg=kind)
    with pytest.raises(ValueError, match="patch stat"):
        patch_stats(torch.from_numpy(x), 16, "max")


@pytest.mark.parametrize("kind", ["mean", "std"])
def test_custom_rank_selects_by_intensity(weights, kind, monkeypatch):
    """custom_rank: each drop block keeps the top patch statistics through
    the reference's full-sequence gather (take_rows, extras not kept in
    front), its indices and logits equal to tpat_tpu's (mirrors
    test_custom_rank_selects_by_intensity); the first drop block's indices
    are the top-k of the input's patch stats; the attention runs without
    scores at the drop blocks."""
    params, x = weights
    cfg = _cfg()
    jmodel = JaxAudioViT(cfg)
    want, wfeats = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, extract_features=True, custom_rank=kind))(
            params, jnp.asarray(x))
    model = _port(cfg, params)
    with torch.no_grad():
        got, gfeats = model(torch.from_numpy(x), extract_features=True,
                            custom_rank=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    for k, v in _topk(wfeats).items():
        np.testing.assert_array_equal(gfeats[k].numpy(), v, err_msg=k)
    stats = np.asarray(jpatch_stats(jnp.asarray(x), 16, kind))
    idx = gfeats["block-1.topk_idx"].numpy()
    np.testing.assert_array_equal(
        idx, np.argsort(-stats, axis=1, kind="stable")[:, :idx.shape[1]])
    # without features, the drop blocks' attention emits no scores
    import tpat_tpu_torch.models.vit as vit

    modes = []
    real = vit.fused_qkv_attention
    monkeypatch.setattr(vit, "fused_qkv_attention",
                        lambda qkv, h, mode, e: modes.append(mode)
                        or real(qkv, h, mode, e))
    with torch.no_grad():
        again = model(torch.from_numpy(x), custom_rank=kind)
    assert modes == [None] * cfg.depth
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0, atol=1e-6)


def test_custom_rank_ignored_under_2d_masking():
    """Under 2D masking (AudioMAE only) the rank is not consulted: the same
    logits with and without it, from the same generator (mirrors
    test_custom_rank_ignored_under_2d_masking); 2D masking refuses AST."""
    from tpat_tpu_torch.config import ViTConfig as PortConfig

    cfg = PortConfig(compute_dtype="float32", embed_dim=32, depth=2,
                     num_heads=2, num_classes=3, target_length=64,
                     num_mel_bins=32, drop_loc=(1,), base_keep_rate=0.5,
                     drop_path_rate=0.0)
    model = AudioViT(cfg).eval()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 1, 64, 32))
                         .astype(np.float32))

    def run(rank):
        with torch.no_grad():
            return model(x, mask_t_prob=0.25, mask_f_prob=0.25, custom_rank=rank,
                         generator=torch.Generator().manual_seed(5))

    assert torch.equal(run("mean"), run(None))
    assert not torch.equal(model(x, custom_rank="mean"), model(x))
    with pytest.raises(ValueError, match="AudioMAE-only"):
        AudioViT(_cfg()).eval()(
            torch.zeros(1, 1, MEL, FRAMES), mask_t_prob=0.2, mask_f_prob=0.2,
            generator=torch.Generator())


def test_kept_count_tables_double_ceil():
    """The host-double ceil (the reference's math.ceil): at keep 0.07 and
    n = 100, 7.000000000000001 -> 8 where the f32 product is 7.0; equal to
    tpat_tpu's tables; identity rows outside drop_loc."""
    tbl = schedules.kept_count_tables((1.0, 0.07), (1,), 128)
    assert tbl[1][100] == 8
    np.testing.assert_array_equal(tbl[0], np.arange(129))
    rates = (1.0, 0.61, 1.0, 0.7, 0.35)
    np.testing.assert_array_equal(
        schedules.kept_count_tables(rates, (1, 3, 4), 258),
        jschedules.kept_count_tables(rates, (1, 3, 4), 258))


@pytest.mark.parametrize("band,blk", [((-0.05, 0.05), 1), ((-0.2, 0.3), 2),
                                      ((-1e9, 1e9), 0)])
def test_intensity_band_eval_matches_jax(weights, band, blk):
    """The band eval step (forward_masked with kept-count tables and the
    band after ``blk``) vs tpat_tpu's make_eval_step: per-sample kept
    counts equal, and equal to the patches whose mean lies in the band
    (for a band after the last drop block); logits atol 1e-5.  A band that
    keeps everything gives the static pruned forward."""
    params, x = weights
    x = x.copy()
    x[0] -= 100.0  # nothing of sample 0 inside a finite band
    cfg = _cfg()
    lo, hi = band
    jstep = jevaluate.make_eval_step(JaxAudioViT(cfg), intensity_band=(lo, hi, blk))
    want, wkept = jstep(params, jnp.asarray(x))
    model = _port(cfg, params)
    got, kept = evaluate.make_eval_step(model, intensity_band=(lo, hi, blk))(
        torch.from_numpy(x))
    np.testing.assert_array_equal(kept.numpy(), np.asarray(wkept))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    if hi < 1e9:
        assert kept[0] == 0
    if blk == 2:  # after the first drop block, before the second
        means = patch_stats(torch.from_numpy(x), 16, "mean").numpy()
        assert (kept.numpy() <= ((means > lo) & (means < hi)).sum(1)).all()
    else:
        with torch.no_grad():
            static = model(torch.from_numpy(x))
        if blk == 0:
            np.testing.assert_allclose(got.numpy(), static.numpy(), rtol=2e-5,
                                       atol=2e-5)


def test_intensity_band_skips_emptied_samples_in_the_metrics(weights):
    """evaluate_classification with the band: a sample the band emptied is
    left out (acc over the others), as tpat_tpu's; the band refuses to be
    combined with features or custom_rank."""
    params, x = weights
    x = x.copy()
    x[0] -= 100.0
    y = np.eye(7, dtype=np.float32)[[0, 1, 2]]
    cfg = _cfg()
    band = (-0.2, 0.3, 1)
    got = evaluate.evaluate_classification(_port(cfg, params), [(x, y)], 3,
                                           intensity_band=band)
    want = jevaluate.evaluate_classification(JaxAudioViT(cfg), params, [(x, y)],
                                             3, intensity_band=band)
    assert got["acc1"] == want["acc1"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    model = _port(cfg, params)
    for bad in (dict(custom_rank="mean"), dict(extract_features=True)):
        with pytest.raises(ValueError, match="intensity_band"):
            evaluate.make_eval_step(model, intensity_band=band, **bad)


def test_ast_config_token_walks():
    """The token walks the card runs: ESC-50 (512 frames) 258 -> 182 -> 128
    -> 91 and AudioSet (1024) 514 -> 361 -> 254 -> 179 at keep 0.7 over
    blocks (3, 6, 9), equal to tpat_tpu's config."""
    for tl, walk in ((512, (258, 182, 128, 91)), (1024, (514, 361, 254, 179))):
        kw = dict(target_length=tl, num_classes=50, base_keep_rate=0.7,
                  drop_loc=(3, 6, 9))
        tpb = ast_vit_base(**kw).tokens_per_block()
        assert tpb == jax_ast_vit_base(**kw).tokens_per_block()
        assert (tpb[0][0], *(tpb[i][1] + 2 for i in (3, 6, 9))) == walk


def test_export_serving_takes_an_ast_pth(weights, tmp_path):
    """cli/export_serving on an AST reference .pth (module.v.*,
    module.mlp_head.*): the AST importer over a fresh model, the artifact's
    input in AST's (n, 1, mel bins, frames) orientation, and load_forward's
    logits equal to the model's on the same weights; the port's own
    checkpoint layout loads strict."""
    from tpat_tpu_torch.cli import export_serving
    from tpat_tpu_torch.utils.serving import load_forward

    params, x = weights
    pth = tmp_path / "ast.pth"
    torch.save({k: torch.from_numpy(v) for k, v in ast_state_dict(params).items()},
               pth)
    cfg = ast_vit_base(target_length=FRAMES, num_mel_bins=MEL, num_classes=7,
                       base_keep_rate=0.6, drop_loc=(1, 3),
                       compute_dtype="float32")
    cfg = dataclasses.replace(cfg, embed_dim=128, depth=4, num_heads=2)

    def export(path, out):
        import tpat_tpu_torch.config as cfg_lib

        real = cfg_lib.ast_vit_base
        cfg_lib.ast_vit_base = lambda **kw: dataclasses.replace(
            real(**kw, num_mel_bins=MEL), embed_dim=128, depth=4, num_heads=2)
        try:
            export_serving.main(export_serving.get_parser().parse_args([
                "--model", "ast_vit_base", "--dataset", "esc50",
                "--nb_classes", "7", "--target_length", str(FRAMES),
                "--base_keep_rate", "0.6", "--drop_loc", "(1, 3)",
                "--compute_dtype", "float32", "--finetuned_model_path",
                str(path), "--batch_size", "1,4", "--out_dir", str(out)]))
        finally:
            cfg_lib.ast_vit_base = real
        return load_forward(str(out), device="cpu")

    fn, meta = export(pth, tmp_path / "a")
    assert meta["input_shape"] == [None, 1, MEL, FRAMES]
    with torch.no_grad():
        want = _port(cfg, params)(torch.from_numpy(x))
    np.testing.assert_allclose(fn(x).numpy(), want.numpy(), rtol=0, atol=1e-6)
    own = tmp_path / "own.pth"
    torch.save({"model": _port(cfg, params).state_dict()}, own)
    fn2, _ = export(own, tmp_path / "b")
    np.testing.assert_allclose(fn2(x).numpy(), want.numpy(), rtol=0, atol=1e-6)
