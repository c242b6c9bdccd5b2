"""The port's own copy of the configuration (tpat_tpu_torch.config) equals
the JAX package's (tpat_tpu.config): every dataclass field and default,
every factory, every dataset preset, the kept-count arithmetic and the
validation.  The test imports both; the port imports only its copy."""

import dataclasses

import pytest

from tpat_tpu import config as jcfg
from tpat_tpu_torch import config as pcfg

FACTORIES = ("audiomae_vit_base", "audiomae_vit_small", "audiomae_vit_large",
             "audiomae_vit_huge", "audiomae_vit_tiny", "ast_vit_base")


def _fields(cls):
    return [(f.name, f.default, f.default_factory, f.type)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ViTConfig", "DataConfig", "TrainConfig"])
def test_dataclass_fields_and_defaults_equal(name):
    assert _fields(getattr(pcfg, name)) == _fields(getattr(jcfg, name))


def _made(factory, kw):
    """The config's fields, or the message it was refused with (the tiny
    model's depth 6 refuses the default drop blocks (3, 6, 9) in both)."""
    try:
        return dataclasses.asdict(factory(**kw))
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", FACTORIES)
def test_factories_equal(name):
    for kw in ({}, {"target_length": 512, "num_classes": 50,
                    "base_keep_rate": 0.7, "drop_loc": (1, 3)}):
        assert _made(getattr(pcfg, name), kw) == _made(getattr(jcfg, name), kw)


def test_dataset_presets_equal():
    assert set(pcfg.DATASET_PRESETS) == set(jcfg.DATASET_PRESETS)
    for k, v in jcfg.DATASET_PRESETS.items():
        assert dataclasses.asdict(pcfg.DATASET_PRESETS[k]) == dataclasses.asdict(v)


def test_derived_values_equal():
    for rates in ((1.0,) * 12, (1.0, 1.0, 1.0, 0.7) * 3, (0.5,) * 12):
        assert pcfg.compose_kept_counts(rates, 256) == jcfg.compose_kept_counts(rates, 256)
    for kw in ({"base_keep_rate": 0.7, "target_length": 512},
               {"patch_stride": 10, "target_length": 1024}):
        p, j = pcfg.audiomae_vit_base(**kw), jcfg.audiomae_vit_base(**kw)
        assert (p.grid_t, p.grid_f, p.num_patches, p.keep_rates,
                p.tokens_per_block()) == (j.grid_t, j.grid_f, j.num_patches,
                                          j.keep_rates, j.tokens_per_block())
    tc = dict(blr=1e-3, batch_size=128)
    assert pcfg.TrainConfig(**tc).resolved_lr(128) == jcfg.TrainConfig(**tc).resolved_lr(128)


@pytest.mark.parametrize("cls,kw", [
    ("ViTConfig", {"compute_dtype": "float16"}),
    ("ViTConfig", {"attn_drop_rate": 0.1}),
    ("ViTConfig", {"gelu_impl": "tanh"}),
    ("ViTConfig", {"dense_init": "kaiming"}),
    ("ViTConfig", {"embed_dim": 100, "num_heads": 3}),
    ("ViTConfig", {"drop_loc": (12,)}),
    ("ViTConfig", {"base_keep_rate": 0.0}),
    ("ViTConfig", {"target_length": 500}),
    ("TrainConfig", {"mask_t_prob": 0.3, "mask_f_prob": 0.2}),
    ("TrainConfig", {"keep_rate_iter_mode": "per_step"}),
])
def test_validation_equal(cls, kw):
    with pytest.raises(ValueError) as want:
        getattr(jcfg, cls)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(pcfg, cls)(**kw)
    assert str(got.value) == str(want.value)
