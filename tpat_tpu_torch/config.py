"""Model and training configuration, shared with the JAX package.

``tpat_tpu.config`` is pure Python (dataclasses, presets and the kept-count
arithmetic, no JAX), so the port re-exports it rather than copying it: one
source of truth for every width, keep rate, schedule knob and dataset
constant.
"""

from tpat_tpu.config import (  # noqa: F401
    DATASET_PRESETS,
    TrainConfig,
    ViTConfig,
    audiomae_vit_base,
    compose_kept_counts,
)
