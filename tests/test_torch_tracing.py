"""The port's tracer (``tpat_tpu_torch/utils/tracing.py``) over a train
step, a pretrain step and a served request, on the CPU: off, nothing is
recorded; under ``torch.profiler.profile`` every span reaches the
profiler's events with the parent, host time and counts it recorded."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpat_tpu_torch.config import TrainConfig, ViTConfig
from tpat_tpu_torch.engine import pretrain, schedules
from tpat_tpu_torch.engine.train import TrainModule
from tpat_tpu_torch.models import mae
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.utils import serving, tracing

T, F, B = 64, 32, 2  # a 4 x 2 grid of patches
DROP, KEEP = (1, 2), 0.5
NAMES = ("train.step", "train.forward", "train.backward", "train.update",
         "pretrain.step", "pretrain.forward", "pretrain.backward",
         "pretrain.update", "vit.prune", "serve.request")


def _vit_cfg(**kw):
    return ViTConfig(**dict(
        compute_dtype="float32", embed_dim=64, depth=3, num_heads=2,
        num_classes=5, target_length=T, num_mel_bins=F, drop_loc=DROP,
        base_keep_rate=KEEP, drop_path_rate=0.0, **kw))


def _module(**kw):
    tc = TrainConfig(batch_size=B, epochs=4, blr=1e-3, min_lr=1e-5,
                     warmup_epochs=1, base_keep_rate=KEEP, drop_loc=DROP,
                     shrink_start_epoch=1, shrink_epochs=2)
    mod = TrainModule(_vit_cfg(**kw), tc, "ce", iters_per_epoch=4,
                      device="cpu")
    return mod, mod.init(seed=0)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 1, T, F)).astype(np.float32)
    return x, np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=B)]


def _static_rows(batch, depth=3):
    """Rows each block's attention sees in the static pruned forward."""
    kept, rows = (T // 16) * (F // 16), 0
    for i in range(depth):
        rows += batch * (1 + kept)
        if i in DROP:
            kept = math.ceil(KEEP * kept)
    return rows


def _hybrid_args(cfg, rate=0.8):
    rates = tuple(rate if i in DROP else 1.0 for i in range(cfg.depth))
    return dict(phase="anneal", keep_rates=rates,
                static_rates=schedules.bucket_keep_rates(
                    rates, base_keep_rate=KEEP, n_buckets=4),
                num_left=schedules.masked_kept_counts(rates, DROP,
                                                      cfg.num_patches))


def _pretrain_step():
    cfg = mae.MAEConfig(embed_dim=32, depth=1, num_heads=2,
                        decoder_embed_dim=32, decoder_depth=1,
                        decoder_num_heads=1, decoder_mode=1, target_length=64,
                        num_mel_bins=64, window_size=(4, 4),
                        compute_dtype="float32")
    model = mae.MaskedAutoencoderViT(cfg)
    opt = pretrain.make_mae_optimizer(model, weight_decay=0.05,
                                      pos_trainable=False)
    step = pretrain.make_mae_train_step(model, opt, 0.75, lambda s: 1e-3)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(B, 1, 64, 64)).astype(np.float32))
    return lambda: step(torch.zeros(()), 0, x)


def _served(tmp_path):
    model = AudioViT(_vit_cfg(), generator=torch.Generator().manual_seed(0))
    out = serving.export_forward(model, (1, 1, T, F), str(tmp_path / "art"),
                                 batch_sizes=(1, 4))
    fn, _ = serving.load_forward(out, device="cpu")
    return fn


def _run_all(tmp_path):
    """A static, a hybrid and a dense train step, a pretrain step and a
    3-clip request (padded to the bucket of 4)."""
    mod, state = _module()
    acc = mod._zero_acc()
    x, y = _batch()
    mod.train_step(state, acc, x, y, "static")
    mod.train_step(state, acc, x, y, **_hybrid_args(mod.model_cfg))
    mod.train_step(state, acc, x, y, "dense", mask_prob=0.3)
    _pretrain_step()()
    _served(tmp_path)(torch.randn(3, 1, T, F))


def test_off_span_is_the_shared_noop_and_nothing_is_recorded(tmp_path):
    tracing.clear()
    assert tracing.span("train.step") is tracing.OFF
    tracing.count("attention_rows", 5)  # no span, no profiler: dropped
    _run_all(tmp_path)
    assert all(not tracing.records(n) for n in NAMES)


def test_on_every_span_reaches_the_profiler_as_recorded(tmp_path):
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_all(tmp_path)
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in NAMES and e.device_type().name == "CPU":
            events.setdefault(e.name(), []).append(e)
    for name in NAMES:
        recs = tracing.records(name)
        got = sorted(events.get(name, []), key=lambda e: e.start_ns())
        assert recs and len(got) == len(recs), name
        # the record's host clock runs inside the profiler's span
        recs = sorted(recs, key=lambda r: r.host_start)
        for r, e in zip(recs, got):
            assert 0 < r.host_s <= (e.end_ns() - e.start_ns()) / 1e9 + 2e-5
            assert r.device_s is None  # no CUDA events on the CPU

    def parents(name):
        return [r.parent for r in tracing.records(name)]

    assert parents("train.step") == [None] * 3
    for phase in ("forward", "backward", "update"):
        assert parents(f"train.{phase}") == ["train.step"] * 3
        assert parents(f"pretrain.{phase}") == ["pretrain.step"]
    # two drop blocks in the static step, two in the hybrid one, none dense;
    # then two in the served forward
    assert parents("vit.prune") == ["train.forward"] * 4 + ["serve.request"] * 2
    assert parents("serve.request") == [None]
    assert not tracing.records("train.grad_sync")  # one process, no ranks

    fwd = [r.counts for r in tracing.records("train.forward")]
    assert fwd[0] == {"attention_rows": _static_rows(B)}
    p = (T // 16) * (F // 16)
    bucket = schedules.bucket_keep_rates((1.0, 0.8, 0.8), base_keep_rate=KEEP,
                                         n_buckets=4)
    w1 = math.ceil(bucket[1] * p)
    assert fwd[1] == {"attention_rows": B * (2 * (1 + p) + 1 + w1)}
    dense = 1 + int((T // 16) * 0.7) * int((F // 16) * 0.7)
    assert fwd[2] == {"attention_rows": 3 * B * dense}
    served = tracing.records("serve.request")[0].counts
    assert served == {"attention_rows": _static_rows(4)}
    assert all(not r.counts for n in ("train.step", "train.update",
                                      "train.backward", "vit.prune")
               for r in tracing.records(n))


@pytest.mark.parametrize("remat", [False, True])
def test_attention_rows_counts_a_remat_block_once(remat):
    """Under ``remat`` the backward recomputes each block of the static
    forward (its pruning runs again, inside ``train.backward``), and the
    rows are counted once, where the block was entered."""
    tracing.clear()
    mod, state = _module(remat=remat)
    x, y = _batch()
    with profile(activities=[ProfilerActivity.CPU]):
        mod.train_step(state, mod._zero_acc(), x, y, "static")
    (fwd,) = tracing.records("train.forward")
    assert fwd.counts == {"attention_rows": _static_rows(B)}
    assert len(tracing.records("vit.prune")) == len(DROP) * (1 + remat)
