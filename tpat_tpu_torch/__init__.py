"""tpat_tpu_torch — the PyTorch/CUDA port of ``tpat_tpu`` for NVIDIA Hopper.

The JAX package ``tpat_tpu`` stays the reference; this package mirrors its
module names with PyTorch inside and replaces each Pallas TPU kernel with a
kernel written by hand for Hopper (``csrc/``, built with nvcc at first use).

Ported so far: the AudioMAE-flavour ViT (``models.vit.AudioViT``: static,
masked and hybrid forwards) with its serving export (``utils.serving``,
``cli.export_serving``), training engine (``engine.train``) and finetune
CLI (``cli.finetune``: the host data pipeline ``data``, ``ops.fbank``,
``engine.evaluate``, ``utils.checkpoint``), the AST CLI
(``cli.run_ast``), the device frontend (``ops.frontend``), feature
extraction and its analysis (``utils.features``, ``analysis``), MAE
pretraining (``models.mae``, ``engine.pretrain``), data parallelism across
processes (``parallel``), the kernels of those paths
(``ops.qkv_attention``, ``ops.window_attention``, ``ops.layernorm``) and
the kernel probes (``probes``).

The package never imports ``jax`` nor any module of ``tpat_tpu``: its
configuration is its own copy (``config``).
"""

from tpat_tpu_torch.config import (  # noqa: F401
    DATASET_PRESETS,
    ViTConfig,
    audiomae_vit_base,
)
