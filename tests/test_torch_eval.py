"""The port's eval path (engine/metrics.py, engine/evaluate.py,
utils/logging.py) and its checkpoint surgery (models/pos_embed.py,
utils/torch_import.py) against the JAX package's, on the CPU.

Tolerances: the metrics are numpy in both packages (the JAX module through
scikit-learn), so they are held bit for bit; eval acc1/acc5 equal, loss and
mAP within 1e-5 (f32 logits through two frameworks); the pos-embed resizes
within 1e-6; the imported model's logits within 1e-5 of JAX's after
``audiomae_params_from_state_dict`` + ``overlay_params``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpat_tpu.config import ViTConfig as JViTConfig
from tpat_tpu.engine import evaluate as jeval
from tpat_tpu.engine import metrics as jmetrics
from tpat_tpu.models import pos_embed as jpe
from tpat_tpu.models.vit import AudioViT as JaxAudioViT
from tpat_tpu.utils import logging as jlogging
from tpat_tpu.utils import torch_import as jti
from tpat_tpu_torch.config import ViTConfig
from tpat_tpu_torch.engine import evaluate
from tpat_tpu_torch.engine import metrics
from tpat_tpu_torch.models import pos_embed as pe
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.utils import logging as logging_lib
from tpat_tpu_torch.utils import torch_import as ti
from tpat_tpu_torch.utils.weights import (
    audiomae_state_dict, jax_flat_from_state_dict, state_dict_from_jax)

EVAL_RTOL = 1e-5  # loss and mAP
POS_ATOL = 1e-6
LOGIT_ATOL = 1e-5


def _kw(**kw):
    base = dict(compute_dtype="float32", embed_dim=64, depth=3, num_heads=2,
                num_classes=6, target_length=64, num_mel_bins=32,
                drop_loc=(1, 2), base_keep_rate=0.5, drop_path_rate=0.0)
    base.update(kw)
    return base


def _jax_params(cfg_kw, seed=0):
    """Seeded JAX params with sharpened qkv (N(0, 1); the rest N(0, 0.05^2)),
    so the two packages' top-k choices are well separated."""
    jcfg = JViTConfig(**dict(cfg_kw, attention_impl="xla"))
    init = JaxAudioViT(jcfg).init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, 1, jcfg.target_length, jcfg.num_mel_bins)),
    )["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name == "pos_embed":
            return np.asarray(leaf)
        scale = 1.0 if "qkv" in name else 0.05
        return (rng.normal(size=np.shape(leaf)) * scale).astype(np.float32)

    return jcfg, jax.tree_util.tree_map_with_path(draw, init)


def _batches(cfg_kw, sizes, seed=1, multilabel=False):
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        x = rng.normal(size=(n, 1, cfg_kw["target_length"],
                             cfg_kw["num_mel_bins"])).astype(np.float32)
        if multilabel:
            y = (rng.uniform(size=(n, cfg_kw["num_classes"])) < 0.4).astype(np.float32)
        else:
            y = np.eye(cfg_kw["num_classes"], dtype=np.float32)[
                rng.integers(0, cfg_kw["num_classes"], size=n)]
        out.append((x, y))
    return out


def _pair(cfg_kw):
    jcfg, params = _jax_params(cfg_kw)
    model = AudioViT(ViTConfig(**cfg_kw))
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return JaxAudioViT(jcfg), params, model


# -- metrics -----------------------------------------------------------------


def test_metrics_match_jax():
    """calculate_stats (every field), mAP, top-k and d' on seeded scores
    rounded to one decimal, so many tie; one class column holds only
    negatives and one only positives."""
    rng = np.random.default_rng(0)
    out = np.round(rng.normal(size=(40, 7)), 1)
    tgt = (rng.random((40, 7)) < 0.3).astype(np.float32)
    tgt[:, 2] = 0.0
    tgt[:, 5] = 1.0
    got, want = metrics.calculate_stats(out, tgt), jmetrics.calculate_stats(out, tgt)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
    assert metrics.mean_average_precision(out, tgt) == \
        jmetrics.mean_average_precision(out, tgt)
    idx = rng.integers(0, 7, size=40)
    assert metrics.topk_accuracy(out, idx, (1, 3, 5)) == \
        jmetrics.topk_accuracy(out, idx, (1, 3, 5))
    for auc in (0.3, 0.5, 0.91):
        assert metrics.d_prime(auc) == jmetrics.d_prime(auc)
    with pytest.raises(ValueError, match="0 or 1"):
        metrics.average_precision(np.array([0.0, 0.5]), np.array([0.1, 0.2]))


# -- eval engine -------------------------------------------------------------


def test_evaluate_classification_and_multilabel_match_jax():
    """Three batches of 8 and a ragged last one of 5 (padded to 8, then
    trimmed): acc1/acc5 equal, loss and mAP within 1e-5."""
    kw = _kw()
    jmodel, params, model = _pair(kw)
    batches = _batches(kw, (8, 8, 5))
    got = evaluate.evaluate_classification(model, batches, 8, device="cpu")
    want = jeval.evaluate_classification(jmodel, params, batches, 8)
    assert (got["acc1"], got["acc5"]) == (want["acc1"], want["acc5"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=EVAL_RTOL)
    ml = _batches(kw, (8, 5), seed=2, multilabel=True)
    np.testing.assert_allclose(
        evaluate.evaluate_multilabel(model, ml, 8)["mAP"],
        jeval.evaluate_multilabel(jmodel, params, ml, 8)["mAP"], rtol=EVAL_RTOL)


def test_eval_loss_weights_batches_equally():
    """The reported CE loss is the unweighted mean of per-batch losses, so a
    ragged last batch counts as much as a full one."""
    kw = _kw(drop_loc=(), base_keep_rate=1.0)
    _, _, model = _pair(kw)
    (x, y), = _batches(kw, (7,))
    stats = evaluate.evaluate_classification(
        model, [(x[:4], y[:4]), (x[4:], y[4:])], batch_size=4)
    with torch.no_grad():
        logp = torch.log_softmax(model.eval()(torch.from_numpy(x)), -1).numpy()
    tgt = np.argmax(y, axis=1)
    l1 = -np.mean(logp[np.arange(4), tgt[:4]])
    l2 = -np.mean(logp[np.arange(4, 7), tgt[4:]])
    np.testing.assert_allclose(stats["loss"], (l1 + l2) / 2.0, rtol=EVAL_RTOL)
    assert abs(stats["loss"] - (-np.mean(logp[np.arange(7), tgt]))) > 1e-9


def test_evaluate_feature_callback_matches_jax():
    """The feature-writer hook: per batch, the trimmed features ('mel',
    block scores and top-k indices) and the labels, as the JAX engine hands
    its writer (``_consume``)."""
    kw = _kw()
    jmodel, params, model = _pair(kw)
    batches = _batches(kw, (4, 3), seed=3)
    names = {i: f"class {i}" for i in range(kw["num_classes"])}
    got, want = [], []
    evaluate.evaluate_classification(
        model, batches, 4, feature_writer=lambda f, b: got.append((b, f)),
        index_to_name=names)
    jeval.evaluate_classification(
        jmodel, params, batches, 4, feature_writer=lambda f, b: want.append((b, f)),
        index_to_name=names)
    assert [b for b, _ in got] == [b for b, _ in want] == [0, 1]
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["labels"] == w["labels"]
        for k in g:
            if k == "labels":
                continue
            if k.endswith("topk_idx"):
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
            else:
                np.testing.assert_allclose(g[k], np.asarray(w[k]), atol=1e-5,
                                           err_msg=k)
        assert len(g["mel"]) == len(g["labels"])


def test_evaluate_refuses_unported():
    """Nothing is refused any more.  ``preprocess`` (refused until the
    device frontend was ported) runs at the head of each eval forward with
    specaug=False and train=False, so the metrics are those of the
    preprocessed batches.  The multi-process gather (refused until data
    parallelism was ported) is the identity in one process, so
    ``allgather=True`` gives the same metrics (its runs across ranks are
    held in test_torch_distributed.py)."""
    kw = _kw()
    _, _, model = _pair(kw)
    batches = _batches(kw, (2, 1))
    seen = []

    def double(x, generator, specaug, train):
        seen.append((generator, specaug, train, x.shape[0]))
        return 2.0 * x

    got = evaluate.evaluate_classification(model, batches, 2, preprocess=double)
    want = evaluate.evaluate_classification(
        model, [(2.0 * x, y) for x, y in batches], 2)
    assert got == want
    assert seen == [(None, False, False, 2)] * 2  # the ragged batch padded
    plain = evaluate.evaluate_classification(model, batches, 2)
    assert evaluate.evaluate_classification(model, batches, 2,
                                            allgather=True) == plain
    assert evaluate.allgather_rows(np.ones((3, 2))).shape == (3, 2)


def test_smoothed_value_and_metric_logger_match_jax():
    """Window median (the lower middle), averages and the log_every lines
    (the final iteration prints too), as the JAX logger."""
    mine, theirs = logging_lib.SmoothedValue(window_size=3), jlogging.SmoothedValue(window_size=3)
    for v in (4.0, 1.0, 3.0, 2.0, 7.0):
        mine.update(v, n=2)
        theirs.update(v, n=2)
        assert str(mine) == str(theirs)
        assert (mine.median, mine.avg, mine.global_avg, mine.max, mine.value) == \
            (theirs.median, theirs.avg, theirs.global_avg, theirs.max, theirs.value)
    lines, jlines = [], []
    ml = logging_lib.MetricLogger(print_fn=lines.append)
    jml = jlogging.MetricLogger(print_fn=jlines.append)
    for logger in (ml, jml):
        for i in logger.log_every(range(7), print_freq=3, header="h"):
            logger.update(loss=float(i))
    assert len(lines) == len(jlines) == 4
    assert sum("[6/7]" in line for line in lines) == 1
    assert str(ml) == str(jml)


# -- pos-embed surgery -------------------------------------------------------


def _table(rows, d=24, seed=0):
    return np.random.default_rng(seed).normal(size=(1, rows, d)).astype(np.float32)


@pytest.mark.parametrize("name,args", [
    ("crop_time_audio_pos_embed", (_table(1 + 8 * 64), (8, 64), (8, 32))),
    ("crop_time_audio_pos_embed", (_table(1 + 8 * 64), (8, 64), (8, 64))),
    ("interpolate_square_pos_embed", (_table(1 + 14 * 14), 9)),
    ("interpolate_square_pos_embed", (_table(2 + 7 * 7), 12, 2)),
    ("interpolate_img2audio_pos_embed", (_table(1 + 14 * 14), (14, 14), (8, 64))),
    ("deit_img2audio_pos_embed", (_table(2 + 24 * 24), 12, 50)),
    ("deit_img2audio_pos_embed", (_table(2 + 24 * 24), 30, 20)),
    ("center_crop_time_ast_pos_embed", (_table(2 + 8 * 64), 50)),
])
def test_pos_embed_surgery_matches_jax(name, args):
    got = getattr(pe, name)(*args)
    want = getattr(jpe, name)(*args)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=POS_ATOL, rtol=0)


def test_resizes_and_rgb_sum_match_jax():
    grid = np.random.default_rng(1).normal(size=(5, 9, 6)).astype(np.float32)
    for out in ((8, 4), (5, 9), (11, 17)):
        np.testing.assert_allclose(pe._bicubic_resize_torch(grid, out),
                                   jpe._bicubic_resize_torch(grid, out), atol=POS_ATOL)
        np.testing.assert_allclose(pe._bilinear_resize_torch(grid, out),
                                   jpe._bilinear_resize_torch(grid, out), atol=POS_ATOL)
    w = np.random.default_rng(2).normal(size=(16, 3, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        pe.sum_rgb_patch_embed(w),
        jpe.sum_rgb_patch_embed(w.transpose(2, 3, 1, 0)).transpose(3, 2, 0, 1),
        atol=POS_ATOL)
    with pytest.raises(ValueError, match="cropped"):
        pe.crop_time_audio_pos_embed(_table(1 + 8 * 8), (8, 8), (8, 16))


# -- state-dict surgery ------------------------------------------------------


def _surgery_kw(**kw):
    """The AudioSet grid is 8 mel patches high: 128 mel bins."""
    return _kw(embed_dim=32, depth=2, drop_loc=(1,), target_length=64,
               num_mel_bins=128, frozen_pos_embed=False, **kw)


def _params_tree(cfg_kw, seed):
    """Seeded flax-layout params (as ``_jax_params``) without a JAX init:
    the tree of the port model's state dict, leaves redrawn."""
    flat = jax_flat_from_state_dict(AudioViT(ViTConfig(**cfg_kw)).state_dict())
    rng = np.random.default_rng(seed)
    tree = {}
    for key, leaf in sorted(flat.items()):
        *path, name = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        scale = 1.0 if "qkv" in key else 0.05
        node[name] = (rng.normal(size=leaf.shape) * scale).astype(np.float32)
    return tree


def _audioset_checkpoint(kw, classes, seed=0, fc_norm=True):
    """A seeded 'pretrained' reference state dict at the AudioSet grid: 513
    pos rows over (8, 64), ``classes`` head rows, and the pretraining
    model's extra keys (norm, mask_token, a decoder weight)."""
    sd = audiomae_state_dict(_params_tree(kw, seed))
    rng = np.random.default_rng(seed + 1)
    d = kw["embed_dim"]
    sd["pos_embed"] = _table(513, d, seed + 1)
    sd["head.weight"] = rng.normal(size=(classes, d)) * 0.05
    sd["head.bias"] = rng.normal(size=(classes,)) * 0.05
    if not fc_norm:
        del sd["fc_norm.weight"], sd["fc_norm.bias"]
    for k, shape in (("norm.weight", (d,)), ("mask_token", (1, 1, d)),
                     ("decoder_embed.weight", (16, d))):
        sd[k] = rng.normal(size=shape)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("classes,fc_norm,logits", [
    (527, True, True), (6, True, False), (6, False, False)])
def test_state_dict_surgery_matches_jax(classes, fc_norm, logits):
    """The port's import (crop (8, 64) -> the model's grid, head dropped on a
    class mismatch, fc_norm kept where present, the pretraining extras left
    out, overlaid on a fresh model) gives the weights of JAX's
    ``audiomae_params_from_state_dict`` + ``overlay_params``, bit for bit,
    and (first case) the same logits within 1e-5.  The fresh parts (the
    head on a mismatch, fc_norm when absent) are the same initial tree in
    both, so the comparison is of the surgery alone."""
    kw = _surgery_kw()
    sd = _audioset_checkpoint(kw, classes, fc_norm=fc_norm)
    init = _params_tree(kw, seed=5)
    jcfg = JViTConfig(**dict(kw, attention_impl="xla"))
    jparams = jti.overlay_params(init, jti.audiomae_params_from_state_dict(
        sd, jcfg, ckpt_grid=(8, 64)))
    cfg = ViTConfig(**kw)
    model = AudioViT(cfg)
    model.load_state_dict(state_dict_from_jax(init), strict=True)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    assert ti.checkpoint_grid(tsd, cfg) == (8, 64)
    imported = ti.audiomae_state_dict_for(tsd, cfg, ckpt_grid=(8, 64))
    assert ("head.weight" in imported) == (classes == 6)
    assert ("fc_norm.weight" in imported) == fc_norm
    assert not {"norm.weight", "mask_token", "decoder_embed.weight"} & set(imported)
    ti.overlay_state_dict(model, imported)
    want_sd = state_dict_from_jax(jparams)
    got_sd = model.state_dict()
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    if logits:
        x = np.random.default_rng(9).normal(size=(3, 1, 64, 128)).astype(np.float32)
        want = np.asarray(JaxAudioViT(jcfg).apply({"params": jparams}, jnp.asarray(x)))
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0)


def test_state_dict_surgery_refuses_mismatches():
    kw = _surgery_kw()
    cfg = ViTConfig(**kw)
    sd = {k: torch.from_numpy(v) for k, v in _audioset_checkpoint(kw, 6).items()}
    with pytest.raises(ValueError, match="pos_embed rows"):
        # a finetuned checkpoint is read at the model's own grid: no crop,
        # and its rows must be the model's
        ti.audiomae_state_dict_for(sd, cfg, ckpt_grid=(cfg.grid_f, cfg.grid_t))
    extra = ti.audiomae_state_dict_for(sd, cfg)
    extra["blocks.7.norm1.weight"] = torch.ones(kw["embed_dim"])
    with pytest.raises(KeyError, match="blocks.7"):
        ti.overlay_state_dict(AudioViT(cfg), extra)
    wrong = ti.audiomae_state_dict_for(sd, cfg)
    wrong["cls_token"] = torch.zeros(1, 1, kw["embed_dim"] + 1)
    with pytest.raises(RuntimeError, match="size mismatch"):
        ti.overlay_state_dict(AudioViT(cfg), wrong)
    # a checkpoint pretrained at another length crops from its own grid
    short = dict(sd, pos_embed=sd["pos_embed"][:, : 1 + 8 * 20])
    assert ti.checkpoint_grid(short, cfg) == (8, 20)
