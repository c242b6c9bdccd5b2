"""tpat_tpu_torch — the PyTorch/CUDA port of ``tpat_tpu`` for NVIDIA Hopper.

The JAX package ``tpat_tpu`` stays the reference; this package mirrors its
module names with PyTorch inside and replaces each Pallas TPU kernel with a
kernel written by hand for Hopper (``csrc/``, built with nvcc at first use).

Ported so far: the static-pruned eval forward of the AudioMAE-flavour ViT
(``models.vit.AudioViT``), its serving export (``utils.serving``,
``cli.export_serving``) and the fused packed-qkv attention kernel
(``ops.qkv_attention``).

The package never imports ``jax``; configuration comes from the pure-Python
``tpat_tpu.config``.
"""

from tpat_tpu_torch.config import (  # noqa: F401
    DATASET_PRESETS,
    ViTConfig,
    audiomae_vit_base,
)
