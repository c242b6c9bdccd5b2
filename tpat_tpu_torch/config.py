"""Model configuration, shared with the JAX package.

``tpat_tpu.config`` is pure Python (dataclasses and presets, no JAX), so the
port re-exports it rather than copying it: one source of truth for every
width, keep rate and dataset constant.
"""

from tpat_tpu.config import (  # noqa: F401
    DATASET_PRESETS,
    ViTConfig,
    audiomae_vit_base,
)
