#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tpat_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, on a machine with an H100 and the CUDA
toolkit:

    python3 chip_smoke.py

Phases; each raises on failure, and the script then exits non-zero without
printing a result:

1. device: requires CUDA, prints the card's name and power limit (nvidia-smi)
   and turns TF32 off for matmuls and convolutions, so the f32 checks compare
   full-f32 arithmetic;
2. build: nvcc builds ``tpat_tpu_torch/csrc/qkv_attention.cu`` for sm_90a
   (in parallel with phase 6's build);
3. kernel vs plain: ``fused_qkv_attention`` against
   ``fused_qkv_attention_plain`` on the card over H=12/D=64 at
   N in {257, 181, 127, 90, 258, 129} (plus H=16/D=80), modes
   patch_mean/cls/none, f32 and bf16 at B=2, and bf16 at the serving path's
   widths and modes at buckets 1/8/32; then, at B=128 and the path's widths,
   compared again and timed with CUDA events; the sha256 of the kernel
   outputs is logged (so two builds can be held to the same bits);
4. serving path at full width: the ViT-B/16 ESC-50 keep-0.7 bf16 model, from
   seeded random weights, saved as a ``.pth``, exported by the port's CLI with
   buckets 1,8,32,128 and served by ``load_forward`` for requests of 1, 5,
   32, 128 and 200 clips; the kernel must run 12 times per bucket forward;
5. model level: the same weights with attention_impl 'fused' vs 'xla', in f32
   (pruning indices exactly equal) and in bf16 at keep 1.0;
6. build: ``tpat_tpu_torch/csrc/qkv_attention_bwd.cu``, with its ptxas report;
7. kernel vs plain for the prefix forward (``fused_qkv_attention_prefix``)
   and the backward (``fused_qkv_attention_bwd``): a grid at B=2, f32 and
   bf16, H=12/D=64 and H=16/D=80, N in {257, 232, 189, 133, 90, 129, 258},
   modes none / patch_mean / cls, kv_valid in {extra+1, middle, N}, the
   backward with and without a score cotangent, prefix and not, each
   backward given the output and the row log-sum-exp L that a recorded
   forward in its own mode writes, and that L held against
   ``torch.logsumexp`` of the plain f32 logits (so with phases 9, 14 and
   23);
8. training path at full width: ``TrainModule.train_epoch`` on ft_esc50's
   ViT-B/16 ESC-50 keep-0.7 bf16 configuration at batch 128 from seeded
   weights, over five epochs of two steps (dense with 2D masking, anneal at
   rates 1.0, hybrid at bucket 1.0, hybrid at bucket 0.8, static), with the
   launches of every step counted and asserted, the geometry of every
   launch recorded, and the ms per step of each epoch through the kernels
   and through plain attention; then one hybrid step at bucket 0.9 (not
   counted) to record its launches too;
9. kernel vs plain at every launch geometry recorded in phase 8 (B=128
   bf16: B1 at N = 111 and the static widths, B2 at each hybrid bucket's
   (N, kv_valid), B3 at all of them), compared and timed with CUDA events in
   turns: B1/B2 as training runs them (writing the row log-sum-exp for the
   backward), B3 through ``fused_qkv_attention_bwd`` with the output and
   log-sum-exp of the forward in the call's own mode passed in (both
   kernels and the wrapper's allocations; the call that is compared)
   against the plain backward, and each of its two kernels alone;
10. one train step in f32, attention_impl 'fused' vs 'xla' from the same
    weights and batch, in each step variant of ``cli/profile_train.py``
    (dense with 2D masking, dense, hybrid at buckets 0.8 and 0.9, static):
    losses, every parameter gradient and the tokens kept at each drop
    block;
11. build: ``tpat_tpu_torch/csrc/window_attention.cu`` and
    ``window_attention_bwd.cu`` (the f32 FMA kernels),
    ``window_attention_dense.cu`` (the bf16 dense form) and
    ``window_attention_banded.cu`` (the bf16 banded form), forward and
    backward (one nvcc per source of the port, all nine started together),
    with their ptxas reports;
12. window kernels vs plain at B=2: the dense form (``fused_window_attention``)
    at N in {64, 256} and the banded form at N in {128, 512}, shifts (0,0)
    and (2,0), H=16/D=32 and H=4/D=32, f32 and bf16, plus one case per form
    and dtype at the scale clamp of 100 (f32 atol scaled with the scale) and
    one bf16 case per form whose template has a row with no live entry
    (uniform p, its query block kept whole by the tensor-core kernels; at N =
    256 more live blocks than the dense kernel's shared-memory slots) and
    a banded one with live entries off the diagonal blocks (the banded
    kernels' general loops); the forward and the backward's d_qkv, d_scale
    and d_template / d_band, the sha256 of the kernel outputs, and each
    case's launches by source (bf16 dense on ``window_attention_dense.cu``,
    bf16 banded on ``window_attention_banded.cu``, f32 on the FMA sources);
13. pretrain path at full width: ``engine/pretrain.py``'s train step on
    ``mae_vit_base_dec512d8b`` (bf16, b32, mask ratio 0.8, seeded weights),
    a few steps on one fixed batch at the AudioSet grid (target length
    1024: the banded kernel) and the ESC-50 grid (512: the dense kernel),
    with the launches of every step counted and asserted, every launch's
    geometry recorded, the loss finite and falling, the frozen pos embeds
    unchanged; then the ms per step through the kernels and through the
    partitioned plain path (``window_attention_impl='xla'``), in turns;
14. every kernel of the pretrain path vs plain at each recorded B=32
    geometry (the window kernels, B1 and B3 at N = 103 and 52), compared and
    timed with CUDA events in turns, beside the library call; the window
    kernels also by their device time (``torch.profiler``), and each window
    backward (dense and banded) run twice more at its geometry, its d_qkv,
    d_scale and d_template / d_band held equal bit for bit;
15. one f32 pretrain step at each grid, the window kernels vs 'xla', from
    the same weights, batch and step generator (the same masks and
    dropout): the loss and every parameter gradient;
16. the LayerNorm kernels (``csrc/layernorm.cu``, built with the others in
    phase 2) vs plain at M in {1, 7, 515, 4112}, every width of
    ``ops.layernorm.WIDTHS``, f32 and bf16: forward y, mu, rstd and backward
    dx, dw, db;
17. ``use_fused_layernorm=True`` at full width: phase 4's artifact served
    with the flag (24 LayerNorm launches per bucket forward asserted, each
    launch's (M, D) recorded) and the ms per b128 forward with the flag and
    without, in turns; phase 8's five epochs with the flag (24 forward and
    24 backward launches per step asserted and recorded, none without the
    flag) and the ms per step with and without, in turns; one f32 train
    step with the flag vs without in each step variant (loss, gradients,
    kept tokens);
18. the LayerNorm kernels vs plain at every geometry recorded in phase 17
    (each serving bucket's and each training step's); those of the b128
    forward and the B=128 steps timed in turns beside the bound and
    ``F.layer_norm``, and the device time of each of the three from
    ``torch.profiler``;
19. the probes: P1's six variants (``probes/probe_attn_softmax.py``) vs
    plain at B=2 (N 33 and 257, f32 and bf16) and B=128 (N 257 and 181),
    P2's nine geometries (``probes/probe_attn_grouping.py``) at the same
    shapes in bf16, and P3
    (``probes/probe_ln_matmul.py``) vs plain at (M, K, N) = (100, 768, 256)
    in f32 and bf16 and, in bf16, (4111, 768, 2304), (32896, 768, 2304) and
    (300, 256, 264), each bf16 case launched three more times for the same
    bits; P3 in bf16 with w = I (K = N = 768, M = 4112), whose output is
    the kernel's rounded LayerNorm, against ``p3.ln`` (the share of entries
    that differ logged); the bf16 P3 kernel's SASS holds HGMMA and UTMALDG
    (where the toolkit has cuobjdump); each probe timed at its shapes; in
    bf16 the nine geometries held to P1 'noscore''s bits, and
    P1 'full' and 'noscore' to B1's out at B=128 within the bf16 limit
    (P1 keeps the mma.sync body B1 had before its wgmma redesign); then
    each probe's ``main()`` with a few iterations (the probes' own path,
    whose launches are counted);
20. the finetune path as users run it: ``scripts/ft_esc50.sh``'s flags
    (ViT-B/16, b128, bf16, keep 0.7 at (3, 6, 9), SpecAug 24/96, roll-mag,
    2D masking at 0.3) through ``tpat_tpu_torch.cli.finetune.main`` on a
    seeded corpus written here (50 classes, 256 train and 200 eval clips
    of 5 s at 16 kHz) from a seeded ViT-B "pretrained" ``.pth`` at the
    AudioSet grid (its pos embed cropped, its 527-class head dropped), cut
    to four epochs (dense, anneal at rates 1.0, anneal at 0.85, static; two
    steps each) with an eval after each: the phases in ``log.txt``, finite
    losses, one best marker, ``best_model`` and the result file; each
    step's launches and their geometry equal to phase 8's step of the same
    kind (recorded there, not typed in), 12 B1 launches per eval forward,
    every launch of the run accounted for; the ms per step, the loader
    wait per step and its share of the epoch, the eval ms per clip; then
    ``--eval`` of ``best_model``, which must give the logged best acc1;
21. the AST path as users run it: ``scripts/ast_run_esc.sh``'s flags
    through ``tpat_tpu_torch.cli.run_ast.main`` on phase 20's corpus from a
    seeded AST "AudioSet-pretrained" ``.pth`` in the reference layout
    (``module.v.*`` and ``module.mlp_head.*``, 514 pos rows, a 527-class
    head), b48 bf16, keep 0.7 at (3, 6, 9), cut to four epochs (dense,
    anneal at rates 1.0, anneal at 0.85 = hybrid bucket 0.9, static; five
    steps each) with an eval of the 200 clips after each: ``result.csv``
    finite, ``best_result.csv``, ``progress.pkl``, ``args.yaml`` and
    ``models/best_audio_model``; each step's and each eval forward's
    launches equal to those the configuration implies (``ast_walk``: mode
    'cls', 2 extra tokens, N 258 -> 182 -> 128 -> 91 static, the bucket
    widths and prefix kv_valid in the anneal, 12 B1 per eval forward),
    every launch of the run accounted for; the ms per step, the loader
    wait and its share, the card ms per eval clip; ``--eval`` of
    ``best_audio_model`` (the logged best score exactly), with
    ``--custom_rank mean`` (no launch carries scores; take_rows widths 258
    -> 180 -> 125 -> 87) and with the intensity band after block 3 (4 B1
    launches per forward, the rest masked plain attention); one static
    forward at ast_run_audioset.sh's geometry (1024 frames, N = 514, b64),
    'fused' vs 'xla' in f32 (logits within the model-level tolerance, the
    same kept tokens at every drop block), its bf16 launches recorded; then
    B1-B3 vs plain at every
    recorded AST geometry, timed beside the bound and the library call;
22. the waveform path and decoding patch importance on phase 20's corpus:
    ``device_frontend`` at b128 on 5-s clips (one with a NaN tail, one
    after a VoxCeleb NaN head of 37 frames) against the host path
    (``fbank_numpy`` -> ``pad_or_crop`` -> ``normalize``) per clip within
    rtol 1e-3 / atol 2e-3, and its ms per batch beside phase 20's loader
    wait; phase 20's run with ``--device_frontend true`` (the epochs'
    phases, each step's launches and geometry as phase 8's walks, the
    hybrid anneal's t = 0 step staying a hybrid step, SpecAug only in the
    dense epoch, the loader wait and step ms beside phase 20's); ``--eval
    --flag_extract_features true`` of its best model (the file set, the
    drop blocks' widths 180/126/89, an attn_score per block, a batch's f32
    kept sets through the kernels equal to 'xla''s), then the port's
    ``extract_stats`` (12 finite Kendall tau per stat, the retained count);
    ``export_serving --device_frontend`` of phase 4's ``.pth`` at buckets
    (1, 8) against phase 4's spectrogram artifact on the frontend's output
    (bf16 tolerance); one b128 dense step with ``remat`` on and off (the
    same loss, gradients within the bf16 tolerance, the peak memory of
    each) and one at drop_rate 0.1;
23. the pretraining run as users run it: ``scripts/run_pretrain.sh``'s flags
    (``mae_vit_base_dec512d8b``, 1024 frames, 2D masking 0.7/0.3,
    ``--norm_pix_loss``, ``--decoder_mode 1``, bf16) through
    ``tpat_tpu_torch.cli.pretrain.main`` on a seeded AudioSet-shaped corpus
    written here (256 clips of 10 s, 527 classes), with its cuts printed:
    batch 32 for two epochs, a resume from ``checkpoint-001`` to a third, a
    ``--resume mae_pretrained.pth`` epoch (the MAE importer), a
    ``--decoder_mode 0`` epoch (the plain decoder: B1/B3 at head_dim 32, N =
    513), one b256 step (the script's batch) with its peak memory; every
    step's launches against the configuration's (encoder N = 96) and every
    step's geometry the same, the logged epochs and finite losses; the
    exported ``.pth`` through the finetune CLI's import into
    ft_esc50.sh's ViT-B (the pos embed's time crop) and one b128 eval
    forward; B1-B3 at head_dim 32 vs plain on a B=2 grid (every mode, the
    prefix form, f32 and bf16), B1/B3 at the decoder-0 step's geometries vs
    plain in bf16 and f32, timed beside SDPA and the bound; one f32
    decoder-0 step, the kernels vs plain attention (loss and gradients);
24. the device dataset cache: phase 22's run (``--device_frontend true``)
    at ``--device_dataset auto`` (the eval set cached, the train set
    declined for roll-mag) and ``false``, then the pair with
    ``--roll_mag_aug false`` (both sets cached): which sets were cached, the
    per-epoch losses within rel 1e-6 and the accuracies equal, the eval ms
    per forward, the loader-wait share and the first-step excess;
25. data parallelism across processes, two ranks on the one card over gloo
    (NCCL refuses two ranks on one device), started once by
    ``torch.distributed.run`` as ``chip_smoke.py --dp-rank <tasks> <dir>``
    to run 25.1, 25.3 and 25.4 in turn:
    25.1 phase 8's configuration (ViT-B/16 ESC-50, bf16, keep 0.7 at
    (3, 6, 9), drop-path 0.1) as one dense step with 2D masking 0.3, one
    hybrid step at bucket 0.8 and one static step, each rank on its 64 rows
    of three seeded b128 global batches, against one process on the
    b128 batches: each rank's B1/B2/B3 launches equal to the one process's,
    the per-step losses and the parameters within ``DP_TOL``, the kept
    tokens equal in every row without a tie; then the same in f32 at depth
    4; the step ms of each rank and the gradient all-reduce's ms;
    25.2 two static b64 steps inside a one-rank NCCL group on the card (the
    weights' broadcast and the gradients' all-reduce on the NCCL backend)
    equal bit for bit to the steps without a group;
    25.3 phase 20's run (ft_esc50.sh's flags, phase 20's corpus) at b64 per
    rank with ``--dist_eval``: each rank's launches equal to phase 20's and
    each step's to phase 8's walk of its kind, each eval reading every clip
    once across the ranks and gathering its 200 rows, equal parameters on
    both ranks, writes only from rank 0 (an audit hook on each rank), the
    logged phases, and the best acc1 equal to a one-process ``--eval`` of
    best_model; the step ms, loader-wait share and epoch ms of each rank
    beside phase 20's;
    25.4 ``run_ast`` (phase 21's flags and corpus) and ``pretrain`` (phase
    23's, decoder 1) on two ranks, two epochs each: equal parameters,
    rank-0-only files, the kernels launched on both ranks;
26. tensor parallelism, two ranks on the one card over gloo (tp = 2, dp
    = 1), started once by ``torch.distributed.run`` as ``chip_smoke.py
    --tp-rank <dir>``:
    26.1 phase 25.1's three steps (dense with 2D masking 0.3, hybrid at
    bucket 0.8, static; drop-path 0.1) at a global b32 with
    ``use_fused_layernorm=True``, in bf16 at depth 12 and f32 at depth 4,
    on both ranks of the model group (each holding half of every block's
    heads and hidden columns) against one process at
    ``attention_impl='xla'``: the losses and gathered parameters within
    ``DP_TOL``, the kept tokens equal in every row without a tie, the
    ranks' gathered parameters equal, each rank's LayerNorm (B4) launches
    equal to the one process's and no B1-B3 launch on either side; the ms
    per step of each rank and the model group's all-reduce ms per step;
    26.2 phase 20's run (its corpus and ft_esc50.sh's flags) at
    ``--batch_size 32 --model_axis 2`` over two epochs (dense, static),
    then ``--eval`` of its best_model on the same two ranks: the logged
    best acc1 equal to the eval's, best_model loaded strict into a tp = 1
    ``AudioViT``, no write from rank 1, no B1-B3 launch;
27. the polynomial GELU (B-G, ``csrc/gelu_poly.cu``, built in phase 2's
    batch): ``gelu_poly`` forward and backward through its autograd
    Function against the eager ops (``gelu_poly_fwd_plain``,
    ``gelu_poly_bwd_plain``) bit for bit, each direction's kernel launched
    once, on every bf16 value, at n 1, 7 and 8k + 3, on views 2 and 6
    bytes off 16, with a non-contiguous x and gradient, at the cells' fc1
    shapes (``GELU_SHAPES``), and in an fc1 -> GELU -> fc2 under
    ``torch.utils.checkpoint`` (every gradient equal to the one without, the
    forward launched twice); one traced b128 static finetune step whose
    ``train.forward`` counts only ``gelu_kernel`` (share 1.0), 3072 x the
    rows its MLPs see; kernel, plain and library (``F.gelu``,
    ``aten.gelu_backward``) ms by CUDA events in turns and by
    ``torch.profiler`` (where it records), beside the byte bound (4 bytes
    an element forward, 6 backward), at (128, 257, 3072) and (256, 512,
    2048); the registers and spills of both kernels;
28. the kernels line, with the entries ``layernorm_fwd``,
    ``layernorm_bwd``, ``attn_probe_variants``, ``attn_probe_grouped``,
    ``ln_matmul``, ``gelu_poly_fwd`` and ``gelu_poly_bwd`` beside those of
    phases 1-15 (the GELU's launches are the main paths' own, each counted
    from zero over its run: phases 4, 8, 13, 20-23 and 26's ranks, held
    to one a block each way in phases 4, 8 and 13 and to the one process's
    in 26); the ``qkv_attention_*``,
    ``window_attention_*``, ``attn_probe_*`` and ``ln_matmul`` entries
    also give the design of their bf16 build and the registers and spill
    bytes of its kernels (per head_dim, per probe variant or geometry, per
    dtype for P3; the FMA kernels beside the window forward and P1) from
    the ptxas report, and the backward and window entries the SDPA backend
    of their library call; ``ln_matmul`` also its SASS check and its w = I
    comparison.

Beside each kernel's time the script computes its bound, the least time the
H100 could take for the same work on these inputs (the largest of the bytes
the call must move at 3.35 TB/s, the FLOPs its data needs at 989 TFLOP/s
bf16, or 67 TFLOP/s for LayerNorm's f32 arithmetic, and, for the
attention kernels B1-B3, B5 and B6, the exps it needs, one per valid
(query, key) pair forward and backward, at 16 a clock per SM on 132 SMs at
the card's maximum SM clock from ``nvidia-smi``), and times the one
PyTorch call that computes the same function, where there is one
(``library_ms``; a yardstick that the port never calls).  A backward's
library call is SDPA's autograd backward, and the window forward's SDPA
itself, under each backend that takes its inputs, the median of several
timed loops, the fastest reported with its backend's name.

The line before the last is a JSON object with each kernel's launches (from
the serving, training and pretrain paths, and the probes' mains), error,
times and bound, and for the attention kernels B1-B3 ``finetune_launches``
and ``ast_launches``, their launches in phase 20's and phase 21's runs,
``waveform_launches`` and ``pretrain_cli_launches``, their launches in
phases 22 and 23, and (B1-B3 and the window kernels) ``dp_launches``, the
summed launches of phase 25's ranks (all also counted in ``launches``),
for the LayerNorm entries ``tp_launches``, those of phase 26's ranks (also
counted in ``launches``), ``ast_ms``, their time per
AST hybrid train step, and for B1/B3 the ``dec0_*`` fields, their head_dim
32 calls per decoder-0 pretrain step (ms, plain, SDPA, bound, launches);
B2's ``noscore``
sums its calls without scores beside SDPA with the key mask; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ast
import concurrent.futures
import contextlib
import dataclasses
import hashlib
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

SEED = 0
# tolerances, kernel vs plain on the same inputs
F32_ATOL = 1e-5  # f32 out: same math, other summation order
BF16_TOL = 2e-2  # bf16 out atol and rtol: p is rounded to bf16 before p.v
SCORE_RTOL, SCORE_ATOL = 1e-3, 1e-6  # scores come from the f32 p in both
# the forward's row log-sum-exp L (bf16 inputs) vs torch.logsumexp of the
# plain f32 logits: the same exact products summed in another order, and
# ex2/lg2.approx (2^-22 relative) over at most 513 keys
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
LSE_CHECKS = {"count": 0, "worst": 0.0}  # every check of L in this run
# model level: logits of 'fused' vs 'xla' through 12 blocks
F32_LOGIT_RTOL, F32_LOGIT_ATOL = 1e-3, 2e-4
BF16_LOGIT_REL = 5e-2  # of the largest |logit|: bf16 rounding of p flips ulps
# gradients, kernel vs plain, as a share of the largest |gradient| of the
# tensor: each entry is a sum over N products whose sizes reach that largest
# entry, taken in another order (FMA chains in the kernel, cuBLAS in plain),
# so the error scales with it; an entrywise rtol would fail on entries near 0
GRAD_F32_REL = 1e-4
GRAD_BF16_REL = 2e-2  # dlog and p are rounded to bf16 at the same points
# one train step in f32, 'fused' vs 'xla', through 12 blocks
STEP_LOSS_RTOL = 1e-4

# ViT-B/16 ESC-50, keep 0.7 at blocks (3, 6, 9): attention calls per forward
PATH_CALLS = (
    (257, None, 3), (257, "patch_mean", 1),
    (181, None, 2), (181, "patch_mean", 1),
    (127, None, 2), (127, "patch_mean", 1),
    (90, None, 2),
)
REQUESTS = (1, 5, 32, 128, 200)
BUCKETS = (1, 8, 32, 128)
STEP_BATCH_F32 = 32  # phase 10

# window attention, kernel vs plain (phases 12, 14): the forward as above;
# the backward's d_qkv, d_scale and d_template each within GRAD_*_REL of the
# tensor's largest |entry| (sums over N or over the batch, taken in another
# order)
PRETRAIN_GRIDS = ((1024, "AudioSet"), (512, "ESC-50"))  # target lengths
PRETRAIN_BATCH = 32  # scripts/bench_mae_step.py's batch
PRETRAIN_STEPS = 4  # counted steps per grid (phase 13)
PRETRAIN_TIMED = 3  # steps per timed turn (phase 13)
# the H100 SXM's published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SCALE_CLAMP = 100.0  # exp(min(logit_scale, log 100)): the largest scale

# LayerNorm (phases 16-18): y, mu and rstd within F32_ATOL or BF16_TOL; dx,
# dw and db within GRAD_*_REL of the tensor's largest |entry| (dw and db are
# sums over M rows taken in another order)
LN_EPS = 1e-6  # the configs' layer_norm_eps
LN_ROWS = (1, 7, 515, 4112)
LN_STEP_LAUNCHES = (24, 24)  # forward, backward: norm1 and norm2 x 12 blocks
# probes (phase 19): the unnormalised outputs (noexp, mmonly) within this
# share of their largest |entry| in f32 (sums of N products of size ~1)
UNNORM_F32_REL = 1e-5
# P3 vs plain at (M, K, N, dtype): the probe's shape, a ragged M, an N that
# is not a multiple of the kernel's 256 columns, a K of four slices
P3_CASES = ((100, 768, 256, torch.float32), (100, 768, 256, torch.bfloat16),
            (4111, 768, 2304, torch.bfloat16),
            (128 * 257, 768, 2304, torch.bfloat16),
            (300, 256, 264, torch.bfloat16))
P3_IDENTITY = (4112, 768, 4)  # M, K = N, inputs (seeds): w = I
PROBE_ITERS = 5  # timed calls per row and repeat of each probe's main()


def log(msg):
    print(msg, flush=True)


def check_device() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs only on an NVIDIA GPU")
    global SM_CLOCK_HZ
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    SM_CLOCK_HZ = float(clock.split()[0]) * 1e6
    log(f"SM clock max {clock}: the exp bound's rate "
        f"{EXPS_PER_SM_CLOCK} x {H100_SMS} SMs x that clock = "
        f"{exp_rate():.4g} exps/s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
        "matmul and cuDNN (f32 checks compare full f32)")
    return smi


def build_kernels():
    """Phases 2, 6, 11, 16 and 27's build: one nvcc per source, all started
    together."""
    from tpat_tpu_torch.ops import _build

    names = ("qkv_attention", "qkv_attention_bwd", "window_attention",
             "window_attention_bwd", "window_attention_dense",
             "window_attention_banded", "layernorm", "attn_probe", "ln_matmul",
             "gelu_poly")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))
    log(f"build: {', '.join(lib.name for lib in libs)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"  ptxas {lib.name.split('.')[0]}: {line.strip()}")


def ptxas_report(name: str) -> dict:
    """{kernel's mangled name: (registers, spill bytes)} from the ptxas
    report (``-Xptxas -v``) kept beside the built ``csrc/<name>.cu``; spill
    bytes are its spill stores plus spill loads."""
    from tpat_tpu_torch.ops import _build

    report, entry, spill = {}, None, 0
    for line in _build.build(name).with_suffix(".log").read_text().splitlines():
        if "Compiling entry function '" in line:
            entry = line.split("'")[1]
        elif "bytes spill stores" in line:
            words = line.replace(",", "").split()
            spill = (int(words[words.index("stores") - 3])
                     + int(words[words.index("loads") - 3]))
        elif "Used" in line and "registers" in line and entry is not None:
            words = line.replace(",", "").split()
            report[entry] = (int(words[words.index("registers") - 1]), spill)
            entry, spill = None, 0
    return report


def build_fields(name: str, design: str, kernels: dict) -> dict:
    """The kernels line's fields for a bf16 build in ``csrc/<name>.cu``: its
    design and, per label of ``kernels`` (label: the substrings that pick
    one kernel's mangled name), the registers and spill bytes ptxas
    reports."""
    regs, spill = {}, {}
    report = ptxas_report(name)
    for label, parts in kernels.items():
        found = [v for e, v in report.items() if all(p in e for p in parts)]
        if len(found) != 1:
            raise AssertionError(f"no single ptxas report of {parts} in "
                                 f"csrc/{name}.cu")
        regs[label], spill[label] = found[0]
    return {"design": design, "registers": regs, "spill_bytes": spill}


QKV_DESIGN = {
    "qkv_attention": (
        "bf16 at head_dim {wgmma}: one consumer warpgroup per 64 query "
        "rows and a producer warp; TMA (one 3-D map over the packed (3C, N, "
        "B) input, 128-byte swizzle at D 64, 64-byte at D 32) into a ring of "
        "two K/V stages under full/empty mbarriers; s = q.k^T as wgmma "
        "m64n64k16 (Q, K from shared memory), p.v as wgmma m64nDk16 (p from "
        "registers, V MN-major); exp2 (ex2.approx) with log2 e folded into "
        "the scale; mode none in ONE sweep (online max and sum, O rescaled, "
        "p~ = 2^(s c - m) rounded to bf16, O / l at the end), "
        "patch_mean/cls in two (K alone for m and l, then K and V); writes "
        "the row log-sum-exp L when recorded for autograd. head_dim {mma} "
        "keeps the mma.sync m16n8k16 body (ldmatrix, cp.async double-buffered "
        "tiles, two sweeps, expf). f32 keeps FMA tiles"),
    "qkv_attention_bwd": (
        "bf16 at head_dim {wgmma}: p = 2^(s c - L log2 e) from the "
        "forward's saved L (no online statistics, no division), delta = "
        "rowsum(dO * O) from the saved output (plus sum p ds on the score "
        "rows, one extra q.k^T sweep); rows: ONE sweep over the keys, s and "
        "dp as wgmma m64n64k16 from shared memory, dq += dlog.k as wgmma "
        "m64nDk16 (dlog from registers, K MN-major); cols: s^T = k.q^T, "
        "dp^T = v.dO^T, dv += p^T.dO and dk += dlog^T.q the same way; TMA "
        "tiles (128-byte swizzle at D 64, 64-byte at D 32) in a ring of two "
        "stages, a producer warp, one consumer warpgroup of 64 rows or "
        "keys. head_dim {mma} keeps the mma.sync m16n8k16 bodies (rows: two "
        "sweeps with m, l and delta online; cols: p from m and 1/l). f32 "
        "keeps FMA tiles"),
}


def bf16_build(name: str, kernel: str) -> dict:
    """``build_fields`` of a qkv_attention kernel (its unmangled name
    without the body's suffix), per head_dim: the wgmma body where the
    forward library says the kernels pass L (``reads_lse``), else the
    mma.sync body (its label says so)."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    dims = {True: [], False: []}
    kernels = {}
    for d in qa.HEAD_DIMS:
        wg = qa.reads_lse(torch.bfloat16, d)
        dims[wg].append(str(d))
        label = str(d) if wg else f"{d} (mma.sync body)"
        kernels[label] = (kernel + ("_wgmma_kernel" if wg else "_mma_kernel"),
                          f"ILi{d}E")
    design = QKV_DESIGN[name].format(wgmma=" and ".join(dims[True]),
                                     mma=" and ".join(dims[False]))
    return build_fields(name, design, kernels)


def probe_builds() -> tuple:
    """``build_fields`` of ``csrc/attn_probe.cu``: (P1's, per variant in
    bf16 and f32; P2's, per geometry)."""
    from tpat_tpu_torch.probes import probe_attn_grouping as p2
    from tpat_tpu_torch.probes import probe_attn_softmax as p1

    design = ("bf16: B1's wgmma/TMA body at D 64: a producer warp issuing "
              "TMA loads of one head's 64-row tiles (128-byte swizzle) into "
              "a ring of two K/V stages under full/empty mbarriers; s = "
              "q.k^T as wgmma m64n64k16 (Q, K from shared memory), p.v as "
              "m64n64k16 (p from registers, V MN-major), ex2.approx; "
              "noscore/exp2 B1's one sweep (online max and sum, O / l at the "
              "end), full B1's two (K alone for m and l, then the "
              "normalised p, its column sums and round(p).v), nomax and "
              "mmonly one sweep without a max (mmonly without exps), noexp "
              "two (the final max, then s scale - m); 64 query rows: one "
              "consumer warpgroup, 128: two sharing each stage, 32: the m64 "
              "products on a 64-row Q box, half of it stored; 2 and 4 heads "
              "per CTA one after the other, one stage counter, the next "
              "head's Q in a second buffer; f32 keeps B1's FMA tiles")
    kernel = "attn_probe_bf16_kernelILi{}ELi{}ELi{}E"
    variants = {v: (kernel.format(64, 1, i),) for i, v in enumerate(p1.VARIANTS)}
    variants.update({f"f32 {v}": (f"attn_probe_f32_kernelILi{i}E",)
                     for i, v in enumerate(p1.VARIANTS)})
    noscore = p1.VARIANTS.index("noscore")
    geometries = {f"{r} rows, {h} heads": (kernel.format(r, h, noscore),)
                  for r in p2.ROWS for h in p2.HEADS}
    return (build_fields("attn_probe", design, variants),
            build_fields("attn_probe", design, geometries))


LN_MATMUL_DESIGN = (
    "bf16: persistent CTAs (one per SM), 128 x 256 output tiles, a row "
    "block's column tiles back to back; a producer warpgroup's thread "
    "issues TMA loads (128-byte swizzle) into a ring of three 48 KB stages "
    "under full/empty mbarriers: per row block x alone twice (the mean, "
    "then the centred variance, from ldmatrix fragments), then x and w per "
    "64-deep slice; two consumer warpgroups (setmaxnreg 232, the producers "
    "40) normalise their ldmatrix fragments of x into bf16 A registers and "
    "issue wgmma m64n256k16 (A from registers, w N-major by descriptor), "
    "waiting per slice; the accumulator leaves through a swizzled shared "
    "buffer and a TMA store. f32 keeps the FMA tiles")
WINDOW_NOTE = (
    "ms by CUDA events around each call's wrapper, which at tens of "
    "microseconds a call includes the host's launch rate; device_ms is the "
    "summed duration of the call's one kernel (torch.profiler)")
WINDOW_DENSE_BUILD = (
    "window_attention_dense",
    "bf16 dense (grids of whole 16-token blocks up to 256), one kernel a "
    "direction: one CTA per (head, batch slice), a warp per 16-row block of "
    "the grid, taking the slice's samples in batch order; the live 16 x 16 "
    "blocks from warp ballots over the template, scanned once per cluster "
    "of the head's CTAs (as many as one wave holds; each CTA reads the "
    "others' bits from their shared memory), their compact slots, the first "
    "32 blocks' template entries in shared memory in the accumulator layout "
    "(the rest read from L2); a sample's q, k, v (and dO) as N x 32 TMA "
    "boxes (3-D maps over the packed input, 64-byte swizzle) into one stage "
    "on an mbarrier, copied out into padded tiles with q and k normalised "
    "and split (split_row), the stage refilled at once with the next "
    "sample; mma.sync m16n8k16, cos, dq^ and dk^ split-bf16, exps by "
    "ex2.approx (__expf); forward m and l online, the first two live "
    "blocks' product chains side by side and their logits kept for p.v; "
    "backward m, l, delta and dq^ by query block, then dk^ and dv by key "
    "block over its live query blocks; d_template per CTA in an L2 slab of "
    "compact slots, the slabs summed in slice order by the last CTA of each "
    "head (integer ticket), the dead blocks zeroed by every CTA of the "
    "head, d_scale one partial a CTA",
    {"fwd": ("window_attention_dense_fwd_kernel",),
     "bwd": ("window_attention_dense_bwd_kernel",)})
WINDOW_BANDED_BUILD = (
    "window_attention_banded",
    "bf16 banded, one kernel a direction: one CTA per (128-token chunk, "
    "head, batch slice), two groups of 8 warps on alternate samples of the "
    "slice in batch order, a warp per 16 rows; the band in shared memory "
    "and its 8 x 8 live map from warp ballots; a sample's q, k, v (and dO) "
    "as 128 x 32 TMA boxes (3-D maps over the packed input, 64-byte "
    "swizzle) into a stage on the group's mbarrier (forward a stage a "
    "group, backward one taken in turns), copied out into padded tiles "
    "with q and k normalised and split (split_row), the stage refilled at "
    "once; mma.sync m16n8k16, cos, dq^ and dk^ split-bf16; forward one "
    "sweep where a query block has one live block (else two); backward "
    "m, l, delta and dq^ by query block and, where each query block's live "
    "block is its own, dk^ and dv from the same fragments transposed "
    "(movmatrix), else a key-major sweep; d_band per group in an L2 slab, "
    "the slabs summed in (slice, group) order by the last CTA of each "
    "(chunk, head) (integer ticket), d_scale one partial a CTA",
    {"fwd": ("window_attention_banded_fwd_kernel",),
     "bwd": ("window_attention_banded_bwd_kernel",)})


def window_build(build, dynamic) -> dict:
    """``build_fields`` of a Hopper window source (``WINDOW_DENSE_BUILD``,
    ``WINDOW_BANDED_BUILD``), with each kernel's shared memory: the static
    bytes ptxas reports plus the dynamic bytes its launch asks for
    (``dynamic(bwd)``)."""
    from tpat_tpu_torch.ops import _build

    fields = build_fields(*build)
    static, entry = {}, None
    log_text = _build.build(build[0]).with_suffix(".log")
    for line in log_text.read_text().splitlines():
        if "Compiling entry function '" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "bytes smem" in line and entry is not None:
            words = line.replace(",", "").split()
            static[entry] = int(words[words.index("smem") - 2])
            entry = None
    fields["shared_bytes"] = {}
    for label, (kernel,) in build[2].items():
        found = [v for e, v in static.items() if kernel in e]
        fields["shared_bytes"][label] = found[0] + dynamic(label == "bwd")
    return fields


# the window backward entries' bound counts the function's work, not the
# kernel's instructions
WINDOW_BWD_NOTE = (
    "bound_ms is the function's work (each input read once, each output "
    "written once, 10 D FLOPs per live pair), not the kernel's "
    "instructions: cos, dq^ and dk^ are three bf16 products each, and both "
    "kernels compute cos and dp twice per sample (by query block, then by "
    "key block) where a block's keys are not its own; device_ms is the "
    "summed duration of the call's one kernel, torch.profiler")


def _close(got, want, atol, rtol) -> float:
    err = (got.float() - want.float()).abs()
    bound = atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or (err > bound).any():
        raise AssertionError(
            f"kernel disagrees with plain: max abs err {err.max().item():.3g}"
            f" (atol {atol}, rtol {rtol})"
        )
    return err.max().item()


def _rel_close(got, want, rel, what) -> float:
    """max |got - want| <= rel * max |want|, for a tensor whose entries are
    sums over many terms whose sizes reach its largest entry (gradients,
    LayerNorm's dw and db, unnormalised outputs): the error scales with that
    entry, and an entrywise rtol would fail on entries near 0.  Returns the
    max abs err."""
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not torch.isfinite(got.float()).all() or not err <= rel * scale:
        raise AssertionError(f"{what}: kernel vs plain max abs err {err:.3g} "
                             f"> {rel} x max|plain| {scale:.3g}")
    return err


def _fold(digest, *tensors):
    """Fold kernel outputs' bytes into ``digest``: phases 3 and 12 log it, so
    that two builds of the same kernels can be held to the same bits."""
    if digest is not None:
        for t in tensors:
            if t is not None:
                digest.update(t.contiguous().cpu().view(torch.uint8).numpy()
                              .tobytes())


def _fwd_pair(qa, kv):
    """(kernel, plain) forward functions of (qkv, h, mode, extra): the
    plain form when kv is None, else the prefix form at kv_valid = kv."""
    if kv is None:
        return qa.fused_qkv_attention, qa.fused_qkv_attention_plain
    return (lambda qkv, *a: qa.fused_qkv_attention_prefix(qkv, kv, *a),
            lambda qkv, *a: qa.fused_qkv_attention_prefix_plain(qkv, kv, *a))


def _compare(qa, qkv, h, mode, extra, kv=None, digest=None):
    """Kernel vs plain on one input; returns (out err, score err)."""
    kern, plain = _fwd_pair(qa, kv)
    with torch.no_grad():
        out, s = kern(qkv, h, mode, extra)
        pout, ps = plain(qkv, h, mode, extra)
    torch.cuda.synchronize()
    _fold(digest, out, s)
    if qkv.dtype == torch.float32:
        e = _close(out, pout, F32_ATOL, 0.0)
    else:
        e = _close(out, pout, BF16_TOL, BF16_TOL)
    if mode is None:
        assert s is None and ps is None
        return e, 0.0
    assert s.shape == (qkv.shape[0], qkv.shape[1] - extra)
    return e, _close(s, ps, SCORE_ATOL, SCORE_RTOL)


def kernel_vs_plain() -> float:
    """The grid at B=2 (H=12/D=64 at path and odd widths, H=16/D=80), then
    bf16 at the serving path's widths, modes and buckets 1/8/32 (bucket 128
    is compared where it is timed)."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    digest = hashlib.sha256()
    worst = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    count = {torch.float32: 0, torch.bfloat16: 0}
    cases = [
        (2, h, d, n, mode, extra, dt)
        for h, d, ns in ((12, 64, (257, 181, 127, 90, 258, 129, 103, 52)),
                         (16, 80, (257, 90)))
        for n in ns
        for mode, extra in (("patch_mean", 1), ("cls", 2), (None, 1))
        for dt in (torch.float32, torch.bfloat16)
    ]
    cases += [
        (b, 12, 64, n, mode, 1, torch.bfloat16)
        for b in BUCKETS[:-1]
        for n, mode, _ in PATH_CALLS
    ]
    for b, h, d, n, mode, extra, dt in cases:
        qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(dt)
        eo, es = _compare(qa, qkv, h, mode, extra, digest=digest)
        worst[dt] = [max(worst[dt][0], eo), max(worst[dt][1], es)]
        count[dt] += 1
    for dt, (eo, es) in worst.items():
        log(f"kernel vs plain, {count[dt]} cases, {dt}: worst out abs err "
            f"{eo:.3g}, worst score abs err {es:.3g}")
    log(f"kernel vs plain: the kernel outputs' sha256 {digest.hexdigest()}")
    return max(max(v) for v in worst.values())


def _time_ms(fn, iters=20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _turns(a, b) -> tuple:
    """Mean ms of a and of b, timed in turns b, a, a, b."""
    b1, a1, a2, b2 = _time_ms(b), _time_ms(a), _time_ms(a), _time_ms(b)
    return (a1 + a2) / 2, (b1 + b2) / 2


def bound_of(parts: dict) -> tuple:
    """(ms, by) of a sum of calls from {by: ms}: the total, labelled by what
    bounds most of it."""
    return sum(parts.values()), max(parts, key=parts.get)


# the special-function unit's exp rate (CUDA C++ Programming Guide, the
# arithmetic-instruction throughput table, compute capability 9.0): 16 a
# clock per SM, on the H100 SXM's 132 SMs, at the card's maximum SM clock
# (read by check_device)
EXPS_PER_SM_CLOCK = 16
H100_SMS = 132
SM_CLOCK_HZ = None


def exp_rate() -> float:
    """Exps per second the card's special-function units can take."""
    if SM_CLOCK_HZ is None:
        raise AssertionError("check_device has not read the SM clock")
    return EXPS_PER_SM_CLOCK * H100_SMS * SM_CLOCK_HZ


def bound_ms(nbytes: float, flops: float, dtype, exps: float = 0.0) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the H100 could take to
    move ``nbytes`` (each input read once, each output written once), do
    ``flops`` on ``dtype`` inputs and take ``exps`` exponentials, the
    largest of the three at the published peaks and ``exp_rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if exps:
        t_ops = max(t_ops, exps / exp_rate() * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def work_bound(work: tuple, dtype) -> tuple:
    """``bound_ms`` of a (bytes, FLOPs, exps) tuple (``qkv_work``,
    ``window_work``)."""
    nbytes, flops, exps = work
    return bound_ms(nbytes, flops, dtype, exps)


def qkv_work(b, n, c3, h, itemsize, mode=None, extra=1, kv=None,
             bwd=False) -> tuple:
    """(bytes, FLOPs, exps) a B1/B2 forward or B3 backward needs: q's N rows
    and k, v's first kv_valid rows (keys past it need neither reading nor
    work), the output, the scores (f32) where a mode asks for them; the
    backward reads dO too and writes the packed gradient.  FLOPs: 4 N kv D
    per (sample, head) forward, 10 N kv D backward (q.k^T, dO.v^T, dq, dk,
    dv).  Exps: one per (query, valid key) pair, B H N kv, forward and
    backward alike (the backward needs p again)."""
    c = c3 // 3
    kv = n if kv is None else kv
    read = n * c + 2 * kv * c
    exps = b * h * n * kv
    if bwd:
        return (itemsize * b * (read + n * c + n * c3),
                10 * b * h * n * kv * (c // h), exps)
    scores = 4 * b * (n - extra) if mode is not None else 0
    return (itemsize * b * (read + n * c) + scores,
            4 * b * h * n * kv * (c // h), exps)


def window_work(qkv, template, banded: bool, bwd: bool) -> tuple:
    """(bytes, FLOPs, exps) a window-attention forward or backward needs on
    these inputs: qkv, the template (f32) and the (H,) scales read, the
    output written; the backward reads dO too and writes d_qkv, d_template
    and d_scale.  FLOPs and exps count only the pairs whose template entry
    is not the -1e30 exclusion (the other probabilities are exact zeros): 4
    D FLOPs per pair forward, 10 D backward, one exp per pair in both."""
    b, n, c3 = qkv.shape
    h = template.shape[0]
    c = c3 // 3
    pairs = int((template > -1e29).sum().item())
    io = qkv.element_size() * b * n
    tmpl = template.numel() * 4 + 4 * h
    if bwd:
        return (io * (c3 + c + c3) + 2 * tmpl, 10 * b * pairs * (c // h),
                b * pairs)
    return io * (c3 + c) + tmpl, 4 * b * pairs * (c // h), b * pairs


def _sdpa_inputs(kind, qkv, h, kv_valid, scale, template, banded):
    """(q, k, v, mask, softmax scale) of the library call for a kernel's
    inputs: kind 'qkv' for B1-B3 (keys at or past kv_valid masked), 'window'
    for B5/B6 as SDPA over (q^ * scale[h], k^, v) with the template (the
    band, chunk by chunk) as an additive mask and no further scaling."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // h
    q, k, v = (t.reshape(b, n, h, d).transpose(1, 2) for t in qkv.chunk(3, -1))
    if kind == "qkv":
        mask, sm_scale = None, d ** -0.5
        if kv_valid is not None:
            mask = (torch.arange(n, device=qkv.device) < kv_valid)[None, None, None]
    else:
        q = F.normalize(q.float(), dim=-1) * scale[:, None, None]
        k = F.normalize(k.float(), dim=-1)
        q, k = q.to(v.dtype), k.to(v.dtype)
        mask, sm_scale = template.to(v.dtype)[None], 1.0
        if banded:
            q, k, v = (t.reshape(b, -1, 128, d) for t in (q, k, v))
            mask = mask.reshape(1, -1, 128, 128)
    return (*(t.contiguous() for t in (q, k, v)), mask, sm_scale)


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")
LIBRARY_LOOPS = 5  # timed loops per backend of a backward's yardstick


def library_ms(kind, qkv, h, *, kv_valid=None, scale=None, template=None,
               banded=False, d_out=None, iters=20, device=False) -> tuple:
    """The yardstick: (ms per call, SDPA backend) of the one PyTorch call
    that computes a kernel's function on the same inputs
    (``_sdpa_inputs``), ``F.scaled_dot_product_attention``, by CUDA events
    around ``iters`` calls after a warm-up; the inputs are prepared outside
    the timed calls.  A 'qkv' forward takes PyTorch's own dispatch (backend
    None).  A 'window' forward, and with ``d_out`` the autograd backward
    alone: the backend choice with a mask is not pinned and spread
    2.5-3.6x between runs, so each backend that takes these inputs is timed
    under ``sdpa_kernel``, as the median of LIBRARY_LOOPS loops, and the
    fastest is reported.  With ``device`` a 'qkv' forward also gives its
    device time (``_device_ms``) as a third value.  The port never calls
    it."""
    import statistics
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, n, c3 = qkv.shape
    q, k, v, mask, sm_scale = _sdpa_inputs(kind, qkv, h, kv_valid, scale,
                                           template, banded)

    def timed(call) -> float:
        for _ in range(3):
            call()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def forward():
        with torch.no_grad():
            F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                           scale=sm_scale)

    if d_out is None and kind == "qkv":
        if device:
            return timed(forward), None, _device_ms(forward)
        return timed(forward), None
    if d_out is not None:
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    best, seen = None, []
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call = forward
                if d_out is not None:
                    out = F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, scale=sm_scale)
                    g = d_out.reshape(b, n, h, -1).transpose(1, 2).reshape(
                        out.shape)

                    def call():
                        torch.autograd.grad(out, (q, k, v), g,
                                            retain_graph=True)
                loops = [timed(call) for _ in range(LIBRARY_LOOPS)]
        except RuntimeError:  # the backend does not take these inputs
            continue
        ms = statistics.median(loops)
        seen.append(f"{name.lower()} {ms:.4f} ({min(loops):.4f}-"
                    f"{max(loops):.4f})")
        if best is None or ms < best[0]:
            best = (ms, name.lower())
    what = "forward" if d_out is None else "backward"
    if best is None:
        raise AssertionError(f"no SDPA backend takes the {kind} {what}")
    log(f"  library {what}, {kind} B={b} N={n}: median (range) of "
        f"{LIBRARY_LOOPS} loops, ms: " + ", ".join(seen))
    return best


def time_kernel():
    """Kernel vs plain at B=128 bf16 for each attention call of the serving
    path, then both timed on that input in turns (plain, kernel, kernel,
    plain); returns the per-forward sums and the worst error."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    total_k = total_p = worst = 0.0
    total_b = {}
    # the calls without scores: kernel, library, their device times
    no_score = [0.0, 0.0, 0.0, 0.0]
    device = 0.0  # the kernels' device time per forward
    digest = hashlib.sha256()
    with torch.no_grad():
        for n, mode, calls in PATH_CALLS:
            qkv = torch.randn(128, n, 3 * 768, device="cuda",
                              generator=gen).to(torch.bfloat16)
            eo, es = _compare(qa, qkv, 12, mode, 1, digest=digest)
            worst = max(worst, eo, es)
            kern = lambda: qa.fused_qkv_attention(qkv, 12, mode, 1)  # noqa: E731
            plain = lambda: qa.fused_qkv_attention_plain(qkv, 12, mode, 1)  # noqa: E731
            k, p = _turns(kern, plain)
            dev = _device_ms(kern)
            device += calls * dev
            bms, by = work_bound(qkv_work(128, n, 3 * 768, 12, 2, mode),
                                 torch.bfloat16)
            lib = "none (scores)"
            if mode is None:
                lib_ms, _, lib_dev = library_ms("qkv", qkv, 12, device=True)
                no_score = [a + calls * t for a, t in
                            zip(no_score, (k, lib_ms, dev, lib_dev))]
                lib = f"{lib_ms:.4f} ms (device {lib_dev:.4f})"
            log(f"time B=128 N={n} mode={mode}: kernel {k:.4f} ms (device "
                f"{dev:.4f}), plain {p:.4f} ms, library {lib}, bound "
                f"{bms:.4f} ms ({by}) (x{calls} per forward); out abs err "
                f"{eo:.3g}, score abs err {es:.3g}")
            total_k += calls * k
            total_p += calls * p
            total_b[by] = total_b.get(by, 0.0) + calls * bms
    log(f"time per b128 forward, all 12 attention calls: kernel "
        f"{total_k:.4f} ms (device {device:.4f}), plain {total_p:.4f} ms, "
        f"bound {sum(total_b.values()):.4f} ms; the 9 calls without scores: "
        f"kernel {no_score[0]:.4f} ms (device {no_score[2]:.4f}), library "
        f"{no_score[1]:.4f} ms (device {no_score[3]:.4f}); the kernel "
        f"outputs' sha256 {digest.hexdigest()}")
    return total_k, total_p, worst, total_b, no_score, device


def sharpened_state_dict(model, seed):
    """Every tensor N(0, 0.05^2) except the qkv weights, N(0, 1): sharp
    attention keeps the importance scores decisively separated, so top-k
    indices are well conditioned (as tests/test_model_parity.py does)."""
    g = torch.Generator().manual_seed(seed)
    return {
        k: torch.randn(v.shape, generator=g) * (1.0 if "qkv" in k else 0.05)
        for k, v in model.state_dict().items()
    }


# the GELU kernels' (forward, backward) launches of each main path, counted
# from zero over the path as the attention kernels' are (phase 27's own
# checks and timings launch them too, and are not counted)
GELU_LAUNCHES = {}


def _gelu_zero():
    from tpat_tpu_torch.ops import fast_gelu as fg

    fg.launches = fg.bwd_launches = 0


def _gelu_read(path) -> tuple:
    """The GELU kernels' (forward, backward) launches since ``_gelu_zero``,
    added to ``GELU_LAUNCHES[path]``."""
    from tpat_tpu_torch.ops import fast_gelu as fg

    got = (fg.launches, fg.bwd_launches)
    had = GELU_LAUNCHES.get(path, (0, 0))
    GELU_LAUNCHES[path] = (had[0] + got[0], had[1] + got[1])
    return got


def _gelu_per_block(path, got, attention):
    """Raises unless the path launched one GELU per attention call each
    way: every block of these models runs one attention and one MLP, so
    the GELU's (forward, backward) launches equal the attention kernels'
    (forward, backward rows)."""
    if tuple(got) != tuple(attention):
        raise AssertionError(f"{path}: GELU launches (fwd, bwd) {got}, the "
                             f"attention's {attention}")


def serving_path(tmp):
    from tpat_tpu_torch.cli import export_serving
    from tpat_tpu_torch.config import audiomae_vit_base
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.utils.serving import load_forward

    cfg = audiomae_vit_base(
        target_length=512, num_classes=50, base_keep_rate=0.7,
        drop_loc=(3, 6, 9), drop_path_rate=0.0, compute_dtype="bfloat16",
    )
    model = AudioViT(cfg, generator=torch.Generator().manual_seed(SEED))
    sd = sharpened_state_dict(model, SEED)
    pth = os.path.join(tmp, "vit_b_esc50.pth")
    torch.save({"model": sd, "epoch": 0}, pth)
    out_dir = os.path.join(tmp, "artifact")
    export_serving.main(export_serving.get_parser().parse_args([
        "--model", "audiomae_vit_base", "--dataset", "esc50",
        "--nb_classes", "50", "--base_keep_rate", "0.7",
        "--drop_loc", "(3, 6, 9)", "--compute_dtype", "bfloat16",
        "--finetuned_model_path", pth,
        "--batch_size", ",".join(map(str, BUCKETS)), "--out_dir", out_dir,
    ]))
    fn, meta = load_forward(out_dir, device="cuda")
    assert meta["batch_sizes"] == list(BUCKETS), meta

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    requests = {n: torch.randn(n, 1, 512, 128, device="cuda", generator=gen)
                for n in REQUESTS}
    torch.cuda.synchronize()

    qa.launches = 0  # the main path starts here
    _gelu_zero()
    per_request = {}
    for n, x in requests.items():
        before = qa.launches
        y = fn(x)
        torch.cuda.synchronize()
        per_request[n] = qa.launches - before
        forwards = math.ceil(n / BUCKETS[-1])
        if per_request[n] != 12 * forwards:
            raise AssertionError(
                f"request of {n}: {per_request[n]} kernel launches, expected "
                f"{12 * forwards} ({forwards} bucket forwards x 12 blocks)")
        if y.shape != (n, 50) or not torch.isfinite(y).all():
            raise AssertionError(f"request of {n}: bad logits {tuple(y.shape)}")
    launches = qa.launches  # the main path ends here
    gelu = _gelu_read("serve")
    _gelu_per_block("serving", gelu, (launches, 0))
    log(f"serving: requests {list(REQUESTS)} answered, launches per request "
        f"{per_request}, total {launches}; GELU launches {gelu}")

    x = requests[128]
    clips = {}
    plain_cfg = dataclasses.replace(cfg, attention_impl="xla")
    plain_fn, _ = load_forward(out_dir, cfg=plain_cfg, device="cuda")
    for name, f in (("kernel", fn), ("plain", plain_fn),
                    ("plain", plain_fn), ("kernel", fn)):
        ms = _time_ms(lambda: f(x), iters=10)
        clips.setdefault(name, []).append(128 / (ms / 1000))
    kernel_cps = sum(clips["kernel"]) / 2
    plain_cps = sum(clips["plain"]) / 2
    log(f"serving b128 bf16: {kernel_cps:.1f} clips/s through the kernel, "
        f"{plain_cps:.1f} clips/s through plain attention")
    return cfg, sd, launches, out_dir


def model_level(cfg, sd):
    from tpat_tpu_torch.models.vit import AudioViT

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn(8, 1, 512, 128, device="cuda", generator=gen)

    def run(dtype, impl, keep_rates=None):
        c = dataclasses.replace(cfg, compute_dtype=dtype, attention_impl=impl)
        m = AudioViT(c, device="cuda")
        m.load_state_dict(sd, strict=True)
        m.eval()
        with torch.no_grad():
            return m(x, keep_rates, extract_features=True)

    # the serving model's feature walk: 256 patches -> 180 -> 126 -> 89
    _, feats = run("bfloat16", "fused")
    widths = [feats[f"block-{i}.topk_idx"].shape[1] for i in (3, 6, 9)]
    if widths != [180, 126, 89]:
        raise AssertionError(f"topk widths {widths}, expected [180, 126, 89]")

    lf, ff = run("float32", "fused")
    lx, fx = run("float32", "xla")
    for i in (3, 6, 9):
        k = f"block-{i}.topk_idx"
        if not torch.equal(ff[k], fx[k]):
            raise AssertionError(f"f32 {k} differs between fused and xla")
    torch.testing.assert_close(lf, lx, rtol=F32_LOGIT_RTOL, atol=F32_LOGIT_ATOL)
    log(f"model f32 fused vs xla: topk_idx equal at blocks 3/6/9, logits max "
        f"abs diff {(lf - lx).abs().max().item():.3g}")

    dense = (1.0,) * cfg.depth
    lf, _ = run("bfloat16", "fused", dense)
    lx, _ = run("bfloat16", "xla", dense)
    diff = (lf - lx).abs().max().item()
    scale = lx.abs().max().item()
    if not diff <= BF16_LOGIT_REL * scale:
        raise AssertionError(
            f"bf16 keep 1.0 fused vs xla: max abs diff {diff:.3g} > "
            f"{BF16_LOGIT_REL} x max|logit| {scale:.3g}")
    log(f"model bf16 keep 1.0 fused vs xla: logits max abs diff {diff:.3g} "
        f"(max |logit| {scale:.3g})")

    lf, ff = run("bfloat16", "fused")
    lx, fx = run("bfloat16", "xla")
    if lf.shape != lx.shape or not (torch.isfinite(lf).all()
                                    and torch.isfinite(lx).all()):
        raise AssertionError("bf16 keep 0.7: bad logits")
    a, b = ff["block-3.topk_idx"], fx["block-3.topk_idx"]
    kept = torch.zeros(a.shape[0], cfg.num_patches, device=a.device)
    ones = torch.ones(a.shape, device=a.device)
    kept.scatter_add_(1, a, ones).scatter_add_(1, b, ones)
    overlap = (kept == 2).sum().item() / a.numel()
    log(f"model bf16 keep 0.7: shapes equal and finite; block-3 kept-set "
        f"overlap {overlap:.4f} (near-ties may flip in bf16)")


def _rel_to_max(got, want, rel, what) -> float:
    """``_rel_close`` for each of dq, dk and dv."""
    return max(_rel_close(g, w, rel, f"{what} d{part}")
               for g, w, part in zip(got.chunk(3, -1), want.chunk(3, -1), "qkv"))


def _saved(qa, qkv, h, mode, extra, kv) -> tuple:
    """What a recorded forward in the call's own mode saves for B3: (out,
    L) from ``_forward_kernel`` with ``want_lse`` where the kernels pass L
    (``reads_lse``), else (None, None).  L is held against torch.logsumexp
    of the plain f32 logits within LSE_ATOL + LSE_RTOL |L|."""
    d = qkv.shape[-1] // 3 // h
    if not qa.reads_lse(qkv.dtype, d):
        return None, None
    with torch.no_grad():
        out, _, lse = qa._forward_kernel(qkv, h, mode, extra, kv,
                                         want_lse=True)
        q, k = (qa._split_heads(t, h).float() for t in qkv.chunk(3, -1)[:2])
        logits = torch.matmul(q, k.transpose(-1, -2)) * d**-0.5
        if kv is not None:
            logits[..., kv:] = float("-inf")
        want = torch.logsumexp(logits, dim=-1)
    torch.cuda.synchronize()
    err = (lse - want).abs()
    if not torch.isfinite(lse).all() or (
            err > LSE_ATOL + LSE_RTOL * want.abs()).any():
        raise AssertionError(
            f"row log-sum-exp n={qkv.shape[1]} kv={kv} mode={mode}: max abs "
            f"err {err.max().item():.3g} (atol {LSE_ATOL}, rtol {LSE_RTOL})")
    LSE_CHECKS["count"] += 1
    LSE_CHECKS["worst"] = max(LSE_CHECKS["worst"], err.max().item())
    return out, lse


def _lse_log(what):
    log(f"row log-sum-exp L vs plain, {what}: {LSE_CHECKS['count']} checks "
        f"in this run so far, worst abs err {LSE_CHECKS['worst']:.3g}")


def _compare_bwd(qa, qkv, d_out, d_scores, h, mode, extra, kv,
                 saved=None) -> float:
    """B3 vs plain as training calls it: with the output and L that a
    recorded forward in the call's own mode saves (``_saved``, made here
    unless given)."""
    out, lse = saved or _saved(qa, qkv, h, mode, extra, kv)
    g = qa.fused_qkv_attention_bwd(qkv, d_out, d_scores, h, mode, extra, kv,
                                   out=out, lse=lse)
    pg = qa.fused_qkv_attention_bwd_plain(qkv, d_out, d_scores, h, mode,
                                          extra, kv)
    torch.cuda.synchronize()
    rel = GRAD_F32_REL if qkv.dtype == torch.float32 else GRAD_BF16_REL
    return _rel_to_max(g, pg, rel, f"bwd n={qkv.shape[1]} kv={kv} mode={mode}")


def prefix_and_bwd_vs_plain():
    """Phase 7, the grid at B=2: the prefix forward at kv_valid in
    {extra+1, middle, N}; the backward with and without a score cotangent,
    prefix (middle kv_valid) and not."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    f32, bf16 = torch.float32, torch.bfloat16
    fwd = {f32: [0.0, 0.0], bf16: [0.0, 0.0]}
    bwd = {f32: 0.0, bf16: 0.0}
    n_fwd = n_bwd = 0
    for h, d in ((12, 64), (16, 80)):
        for n in (257, 232, 189, 133, 90, 129, 258, 103, 52):
            for mode, extra in ((None, 1), ("patch_mean", 1), ("cls", 2)):
                mid = (extra + 1 + n) // 2
                for dt in (f32, bf16):
                    qkv = torch.randn(2, n, 3 * h * d, device="cuda",
                                      generator=gen).to(dt)
                    for kv in (extra + 1, mid, n):
                        eo, es = _compare(qa, qkv, h, mode, extra, kv)
                        fwd[dt] = [max(fwd[dt][0], eo), max(fwd[dt][1], es)]
                        n_fwd += 1
                    d_out = torch.randn(2, n, h * d, device="cuda",
                                        generator=gen).to(dt)
                    cots = [None]
                    if mode is not None:
                        cots.append(n * torch.randn(2, n - extra, device="cuda",
                                                    generator=gen))
                    for kv in (None, mid):
                        for ds in cots:
                            err = _compare_bwd(qa, qkv, d_out, ds, h, mode,
                                               extra, kv)
                            bwd[dt] = max(bwd[dt], err)
                            n_bwd += 1
    for dt in (f32, bf16):
        log(f"prefix fwd vs plain, {dt}: worst out abs err {fwd[dt][0]:.3g}, "
            f"worst score abs err {fwd[dt][1]:.3g}; bwd vs plain, {dt}: worst "
            f"abs err {bwd[dt]:.3g}")
    log(f"kernel vs plain at B=2: {n_fwd} prefix forwards, {n_bwd} backwards")
    _lse_log("phase 7")
    return (max(max(v) for v in fwd.values()), max(bwd.values()))


def _counts(qa):
    return (qa.launches, qa.prefix_launches, qa.bwd_rows_launches,
            qa.bwd_cols_launches)


@contextlib.contextmanager
def _recording(qa, calls):
    """Route the kernel launchers through a recorder: each launch appends
    its geometry, (kind, B, N, 3C, dtype, H, mode, extra, kv_valid, whether a
    score cotangent came), to ``calls``.  The launchers still count."""
    fwd, bwd = qa._forward_kernel, qa._backward_kernels

    def forward(qkv, num_heads, mode, extra, kv_valid, **kw):
        calls.append(("fwd", *qkv.shape, qkv.dtype, num_heads, mode, extra,
                      kv_valid, False))
        return fwd(qkv, num_heads, mode, extra, kv_valid, **kw)

    def backward(qkv, d_out, d_scores, num_heads, mode, extra, kv_valid, *a):
        calls.append(("bwd", *qkv.shape, qkv.dtype, num_heads, mode, extra,
                      kv_valid, d_scores is not None))
        return bwd(qkv, d_out, d_scores, num_heads, mode, extra, kv_valid, *a)

    qa._forward_kernel, qa._backward_kernels = forward, backward
    try:
        yield
    finally:
        qa._forward_kernel, qa._backward_kernels = fwd, bwd


def _timed(batches, steps, counts, calls):
    """Yield the batches, recording each step's ms, launch counts (the
    change of ``counts()``) and recorded launches."""
    for x, y in batches:
        torch.cuda.synchronize()
        c0, i0, t0 = counts(), len(calls), time.perf_counter()
        yield x, y
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        steps.append((ms, tuple(a - b for a, b in zip(counts(), c0)),
                      tuple(calls[i0:])))


def _train_configs(dtype, drop_path_rate):
    """ft_esc50's configuration (``cli/profile_train.py``) at ``dtype`` and
    ``drop_path_rate``, its schedule cut to five epochs: dense, three of
    anneal, static."""
    from tpat_tpu_torch.cli import profile_train

    cfg, tc = profile_train.train_configs()
    cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                              drop_path_rate=drop_path_rate)
    tc = dataclasses.replace(tc, epochs=5, warmup_epochs=1,
                             shrink_start_epoch=1, shrink_epochs=3)
    return cfg, tc


# per-step launches (forward, prefix forward, bwd rows, bwd cols) by epoch
STEP_LAUNCHES = {0: (12, 0, 12, 12), 1: (12, 0, 12, 12), 2: (4, 8, 12, 12),
                 3: (4, 8, 12, 12), 4: (12, 0, 12, 12)}
EPOCH_LABELS = ("dense, 2D masking", "anneal, rates 1.0 (dense step)",
                "anneal, hybrid at bucket 1.0", "anneal, hybrid at bucket 0.8",
                "static")
BUCKET_09 = "hybrid at bucket 0.9 (one step, not counted)"


def _run_epochs(cfg, tc, sd, batches, counts, calls, what):
    """Phase 8's five epochs of ``TrainModule.train_epoch`` (two steps each)
    from the weights ``sd``: each step's (ms, launch counts, recorded
    launches) and each epoch's loss.  Raises unless the phases are dense,
    anneal x3, static, the losses finite and the frozen pos_embed
    unchanged."""
    from tpat_tpu_torch.engine.train import TrainModule

    mod = TrainModule(cfg, tc, "ce", iters_per_epoch=2, device="cuda")
    state = mod.load(sd, seed=SEED)
    steps, phases, losses = [], [], []
    for epoch in range(5):
        state, stats = mod.train_epoch(
            state, _timed(batches, steps, counts, calls), epoch)
        phases.append(stats["phase"])
        losses.append(stats["loss"])
    if not torch.equal(state.model.pos_embed, sd["pos_embed"].to("cuda")):
        raise AssertionError(f"{what}: the frozen pos_embed moved")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: losses {losses}")
    if phases != ["dense", "anneal", "anneal", "anneal", "static"]:
        raise AssertionError(f"{what}: phases {phases}")
    del state, mod
    torch.cuda.empty_cache()
    return steps, losses


def training_path(sd):
    """Phase 8: train_epoch at full width through the kernels (the counted
    main path, every launch recorded), then in turns through plain attention
    and the kernels (plain, kernel, kernel, plain) for the ms per step;
    then one recorded hybrid step at bucket 0.9.  Returns the main
    path's launch counts, {walk: one step's recorded launches} and {walk:
    the mean ms of the second steps through the kernels}."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine import schedules
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.ops import qkv_attention as qa

    cfg, tc = _train_configs("bfloat16", 0.1)
    sched = {}
    for epoch in (2, 3):
        rates = schedules.scheduled_keep_rates(
            epoch * 2, epoch, shrink_start_epoch=1, total_epochs=4,
            iters_per_epoch=2, base_keep_rate=0.7)
        sched[epoch] = (rates[3], schedules.bucket_keep_rates(
            rates, base_keep_rate=0.7, n_buckets=4)[3])
    if not (abs(sched[2][0] - 0.925) < 1e-9 and sched[2][1] == 1.0
            and abs(sched[3][0] - 0.775) < 1e-9 and abs(sched[3][1] - 0.8) < 1e-9):
        raise AssertionError(f"schedule at epochs 2, 3: {sched}")
    batches = profile_train.synthetic_batches(
        cfg, profile_train.TRAIN_BATCH, 2, SEED + 4)

    def run(impl, count):
        calls = []
        with _recording(qa, calls):
            if count:
                qa.launches = qa.prefix_launches = 0  # the main path starts here
                qa.bwd_rows_launches = qa.bwd_cols_launches = 0
                _gelu_zero()
            steps, losses = _run_epochs(
                dataclasses.replace(cfg, attention_impl=impl), tc, sd, batches,
                lambda: _counts(qa), calls, impl)
            counts = _counts(qa)  # the main path ends here
            if count:
                _gelu_per_block("training", _gelu_read("train"),
                                (counts[0] + counts[1], counts[2]))
        return steps, losses, counts

    k_steps, losses, counts = run("fused", True)
    walks = {}
    for i, (_, got, calls) in enumerate(k_steps):
        want = STEP_LAUNCHES[i // 2]
        if got != want:
            raise AssertionError(
                f"step {i} (epoch {i // 2}): launches (fwd, prefix fwd, bwd "
                f"rows, bwd cols) {got}, expected {want}")
        walk = walks.setdefault(EPOCH_LABELS[i // 2], calls)
        if walk != calls:
            raise AssertionError(f"the two steps of epoch {i // 2} launched "
                                 "at different geometries")
    log(f"training: phases dense, anneal x3, static; losses per epoch "
        f"{[round(v, 4) for v in losses]}; launches per step as expected; "
        f"totals (fwd, prefix fwd, bwd rows, bwd cols) {counts}")
    # timed after the counted run, which warms the process up
    x1, _, _ = run("xla", False)
    k1, _, _ = run("fused", False)
    k2, _, _ = run("fused", False)
    x2, _, _ = run("xla", False)
    step_ms = {}
    for epoch, label in enumerate(EPOCH_LABELS):
        # the second step of each epoch in each run: the first one runs the
        # epoch's widths for the first time (allocator growth, cuBLAS
        # heuristics)
        k = [s[2 * epoch + 1][0] for s in (k1, k2)]
        step_ms[label] = sum(k) / 2
        p = [s[2 * epoch + 1][0] for s in (x1, x2)]
        first = [s[2 * epoch][0] for s in (k1, k2, x1, x2)]
        widths = sorted({c[2] for c in walks[label]}, reverse=True)
        log(f"train step b128 bf16, epoch {epoch} ({label}; N {widths}): "
            f"kernels {sum(k) / 2:.1f} ms, plain attention {sum(p) / 2:.1f} "
            f"ms (second steps {[round(v, 1) for v in k]} / "
            f"{[round(v, 1) for v in p]}; first steps, kernel, kernel, "
            f"plain, plain: {[round(v, 1) for v in first]})")

    mod = TrainModule(dataclasses.replace(cfg, attention_impl="fused"), tc,
                      "ce", iters_per_epoch=2, device="cuda")
    state = mod.load(sd, seed=SEED)
    calls = []
    with _recording(qa, calls):
        mod.loss_and_grads(state, *batches[0],
                           **profile_train.step_variants(cfg)["hybrid_0.9"])
    torch.cuda.synchronize()
    walks[BUCKET_09] = tuple(calls)
    del state, mod
    torch.cuda.empty_cache()
    return counts, walks, step_ms


def path_kernels_vs_plain(walks):
    """Phase 9: each distinct launch geometry of the recorded training walks,
    kernel vs plain on a seeded input of that geometry, then both timed in
    turns.  A forward is timed as training runs it, writing the row
    log-sum-exp L where its backward reads it (``_forward_kernel`` with
    ``want_lse``).  B3 is timed through ``fused_qkv_attention_bwd`` with
    the forward's output and L passed in (both kernels and the wrapper's
    allocations and score-cotangent work) against the plain backward, and
    each of its two kernels alone on the wrapper's arguments.  Beside each: its bound and, where one exists, the library
    call's time (none for a forward that emits scores or a backward with a
    score cotangent).  Returns ({walk: per-step sums}, {kernel: worst
    error})."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    lib = qa._bwd_library()
    ms, yard = {}, {}
    worst = {"B1": 0.0, "B2": 0.0, "B3": 0.0}
    for call in sorted({c for w in walks.values() for c in w}, key=str):
        kind, b, n, c3, dt, h, mode, extra, kv, has_ds = call
        qkv = torch.randn(b, n, c3, device="cuda", generator=gen).to(dt)
        where = f"B={b} N={n} kv_valid={kv} mode={mode}"
        bnd = work_bound(qkv_work(b, n, c3, h, qkv.element_size(), mode,
                                  extra, kv, bwd=kind == "bwd"), dt)
        if kind == "fwd":
            name = "B1" if kv is None else "B2"
            eo, es = _compare(qa, qkv, h, mode, extra, kv)
            worst[name] = max(worst[name], eo, es)
            _, plain = _fwd_pair(qa, kv)
            with torch.no_grad():
                ms[call] = _turns(
                    lambda: qa._forward_kernel(qkv, h, mode, extra, kv,
                                               want_lse=True),
                    lambda: plain(qkv, h, mode, extra))
            yard[call] = (bnd, *((None, None) if mode is not None else
                                 library_ms("qkv", qkv, h, kv_valid=kv)))
            log(f"{name} {where}: kernel {ms[call][0]:.4f} ms, plain "
                f"{ms[call][1]:.4f} ms, library {yard[call][1]} ms, bound "
                f"{bnd[0]:.4f} ms ({bnd[1]}); out abs err {eo:.3g}, score abs "
                f"err {es:.3g}")
            continue
        d_out = torch.randn(b, n, c3 // 3, device="cuda", generator=gen).to(dt)
        ds = (n * torch.randn(b, n - extra, device="cuda", generator=gen)
              if has_ds else None)
        out, lse = _saved(qa, qkv, h, mode, extra, kv)
        worst["B3"] = max(worst["B3"], _compare_bwd(
            qa, qkv, d_out, ds, h, mode, extra, kv, saved=(out, lse)))
        pair, plain = _turns(
            lambda: qa.fused_qkv_attention_bwd(qkv, d_out, ds, h, mode, extra,
                                               kv, out=out, lse=lse),
            lambda: qa.fused_qkv_attention_bwd_plain(qkv, d_out, ds, h, mode,
                                                     extra, kv))
        args, _dqkv, _keep = qa._bwd_launch_args(qkv, d_out, ds, h, mode,
                                                 extra, kv, out, lse)
        rows = lambda: lib.tpat_qkv_attention_bwd_rows(*args)  # noqa: E731
        cols = lambda: lib.tpat_qkv_attention_bwd_cols(*args)  # noqa: E731
        if rows() != 0 or cols() != 0:
            raise AssertionError("backward kernel launch failed")
        r, c = _turns(rows, cols)
        ms[call] = (r, c, pair, plain)
        lib_bwd = (None, None) if has_ds else library_ms(
            "qkv", qkv, h, kv_valid=kv, d_out=d_out)
        yard[call] = (bnd, *lib_bwd)
        log(f"B3 {where} score cotangent {has_ds}: rows {r:.4f} + cols "
            f"{c:.4f} ms; through fused_qkv_attention_bwd {pair:.4f} ms, "
            f"plain backward {plain:.4f} ms, library backward {lib_bwd[0]} "
            f"ms ({lib_bwd[1]}), bound {bnd[0]:.4f} ms ({bnd[1]})")
    sums = {}
    for name, walk in walks.items():
        s = {"B1": [0.0, 0.0], "B2": [0.0, 0.0], "B3": [0.0] * 4}
        for key in ("B1", "B2", "B3"):
            s[key + "bound"], s[key + "lib"], s[key + "backends"] = {}, 0.0, set()
            # the forward calls without scores, which the library call
            # computes: their count, kernel ms and library ms
            s[key + "noscore"] = [0, 0.0, 0.0]
        for call in walk:
            key = "B3" if call[0] == "bwd" else "B1" if call[8] is None else "B2"
            s[key] = [a + t for a, t in zip(s[key], ms[call])]
            (bms, by), lib_ms, backend = yard[call]
            s[key + "bound"][by] = s[key + "bound"].get(by, 0.0) + bms
            s[key + "lib"] = (None if lib_ms is None or s[key + "lib"] is None
                              else s[key + "lib"] + lib_ms)
            if key != "B3" and call[6] is None:
                s[key + "noscore"] = [s[key + "noscore"][0] + 1,
                                      s[key + "noscore"][1] + ms[call][0],
                                      s[key + "noscore"][2] + lib_ms]
            if backend is not None:
                s[key + "backends"].add(backend)
        sums[name] = s
        b1, b2, b3 = s["B1"], s["B2"], s["B3"]
        n2, k2, l2 = s["B2noscore"]

        def yardsticks(key):
            lib = s[key + "lib"]
            lib = "none (scores)" if lib is None else f"{lib:.4f}"
            return (f"library {lib}, bound "
                    f"{sum(s[key + 'bound'].values()):.4f}")

        log(f"per step, {name}: B1 {b1[0]:.4f} ms (plain {b1[1]:.4f}, "
            f"{yardsticks('B1')}); B2 {b2[0]:.4f} ms (plain {b2[1]:.4f}, "
            f"{yardsticks('B2')}; its {n2} calls without scores {k2:.4f} ms, "
            f"library {l2:.4f}); B3 rows {b3[0]:.4f} + cols {b3[1]:.4f} ms, "
            f"through fused_qkv_attention_bwd {b3[2]:.4f} ms (plain backward "
            f"{b3[3]:.4f}, {yardsticks('B3')})")
    log("kernel vs plain at the training path's geometries: worst abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    _lse_log(", ".join(walks))
    return sums, worst


ATTENTION_PAIR = ({"attention_impl": "fused"}, {"attention_impl": "xla"})
LAYERNORM_PAIR = ({"use_fused_layernorm": True}, {"use_fused_layernorm": False})


def train_step_f32(sd, pair=ATTENTION_PAIR, what="kernels vs plain attention"):
    """Phase 10 (and 17 with ``LAYERNORM_PAIR``): one f32 train step's loss
    and gradients, the config change ``pair[0]`` (kernels) vs ``pair[1]``
    (plain), same weights and batch, no drop-path, in each step variant of
    ``cli/profile_train.py``."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.ops import pruning

    cfg, tc = _train_configs("float32", 0.0)
    (x, y), = profile_train.synthetic_batches(cfg, STEP_BATCH_F32, 1,
                                              SEED + 5)
    topk = pruning.topk_select
    picked = []

    def recording_topk(scores, k):
        idx = topk(scores, k)
        picked.append(idx)
        return idx

    pruning.topk_select = recording_topk
    try:
        for name, kw in profile_train.step_variants(cfg).items():
            res = []
            for change in pair:
                c = dataclasses.replace(cfg, **change)
                mod = TrainModule(c, tc, "ce", iters_per_epoch=2, device="cuda")
                state = mod.load(sd, seed=SEED)
                picked.clear()
                loss, grads = mod.loss_and_grads(state, x, y, **kw)
                names = [n for g in state.optimizer.param_groups
                         for n in g["names"]]
                res.append((loss.item(), dict(zip(names, grads)), list(picked)))
            (lf, gf, tf), (lx, gx, tx) = res
            if not abs(lf - lx) <= STEP_LOSS_RTOL * abs(lx):
                raise AssertionError(f"{name}: loss {lf} vs {lx}")
            drops = 0 if kw["phase"] == "dense" else len(cfg.drop_loc)
            if len(tf) != drops or len(tx) != drops:
                raise AssertionError(f"{name}: {len(tf)} / {len(tx)} top-k "
                                     f"calls, expected {drops}")
            kept = [kw["num_left"][i] if "num_left" in kw else None
                    for i in cfg.drop_loc]
            reordered = _same_kept_tokens(name, tf, tx, kept, cfg.num_patches)
            worst = 0.0
            for k, g in gx.items():
                err = (gf[k] - g).abs().max().item()
                scale = g.abs().max().item()
                if not err <= GRAD_F32_REL * scale:
                    raise AssertionError(
                        f"{name}: grad {k} err {err:.3g} > {GRAD_F32_REL} x "
                        f"{scale:.3g}")
                worst = max(worst, err / scale if scale else 0.0)
            log(f"f32 train step, {what}, {name}, b{STEP_BATCH_F32}: loss "
                f"{lf:.6f} vs {lx:.6f} (plain); the same kept tokens at {drops} drop "
                f"blocks (rows ranked in another order, per block: "
                f"{reordered}); {len(gx)} parameter gradients, worst err / "
                f"max|grad| {worst:.3g}")
    finally:
        pruning.topk_select = topk


def _same_kept_tokens(name, picked_f, picked_x, kept, num_patches):
    """Both runs keep the same patch tokens at every drop block.  Each
    top-k call's indices are composed through the earlier gathers into
    original patch ids; the kept ones are the first ``kept`` (the hybrid's
    num_left prefix) or all k (static).  Their sets must be equal.  The
    order inside the set is not compared: two tokens whose scores agree to
    ~1e-6 relative (the kernel's scores differ from plain by that much) may
    rank either way, and a permutation of kept tokens changes no loss or
    gradient, which are compared on their own.  Returns the number of rows
    ranked in another order at each block."""
    ids_f = ids_x = None
    reordered = []
    for block, (jf, jx, k) in enumerate(zip(picked_f, picked_x, kept)):
        if ids_f is None:
            ids_f = ids_x = torch.arange(num_patches, device=jf.device).expand(
                jf.shape[0], -1)
        ids_f, ids_x = ids_f.gather(1, jf), ids_x.gather(1, jx)
        k = ids_f.shape[1] if k is None else k
        a = ids_f[:, :k].sort(dim=1).values
        b = ids_x[:, :k].sort(dim=1).values
        if not torch.equal(a, b):
            raise AssertionError(
                f"{name}: drop block {block}: the kept tokens differ in "
                f"{(a != b).any(1).sum().item()} rows")
        reordered.append((ids_f != ids_x).any(1).sum().item())
    return reordered


# ---------------------------------------------------------------------------
# Phases 12-15: the window kernels and the pretrain path
# ---------------------------------------------------------------------------


def _window_inputs(b, h, d, feat, shift, banded, dt, gen, scale_value=None):
    """A seeded window-attention call on the card: qkv (window-major when
    banded), scales around the model's initial 10 (exp of log 10 +
    N(0, 0.5^2)) or all ``scale_value``, the template or band of a random
    meta-MLP bias with the shift's region mask, and d_out."""
    from tpat_tpu_torch.models.mae import _shift_attn_mask
    from tpat_tpu_torch.ops import window_attention as wa

    n = feat[0] * feat[1]
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen).to(dt)
    scale = torch.exp(
        0.5 * torch.randn(h, device="cuda", generator=gen) + math.log(10.0))
    if scale_value is not None:
        scale = torch.full_like(scale, scale_value)
    bias = torch.randn(h, 16, 16, device="cuda", generator=gen)
    mask = _shift_attn_mask(feat, (4, 4), shift)
    if banded:
        tmpl, perm, _ = wa.build_band_template(bias, feat, (4, 4), shift, mask)
        qkv = qkv[:, torch.as_tensor(perm, device="cuda")]
    else:
        tmpl = wa.build_window_template(bias, feat, (4, 4), shift, mask)
    d_out = torch.randn(b, n, h * d, device="cuda", generator=gen).to(dt)
    return qkv.contiguous(), scale, tmpl.contiguous(), d_out


def _window_fns(wa, banded):
    """(kernel forward, plain forward, plain backward) of one form."""
    if banded:
        return (wa.fused_window_attention_banded,
                wa.fused_window_attention_banded_plain,
                wa.fused_window_attention_banded_bwd_plain)
    return (wa.fused_window_attention, wa.fused_window_attention_plain,
            wa.fused_window_attention_bwd_plain)


def _compare_window(wa, qkv, scale, tmpl, d_out, banded, what,
                    f32_atol=F32_ATOL, digest=None) -> tuple:
    """Kernel vs plain, forward and backward, on one input: (forward abs
    err, backward abs err, backward err / max|plain|, the largest over its
    outputs).  The f32 forward within ``f32_atol``, bf16 within BF16_TOL;
    the backward's outputs d_q, d_k, d_v, d_scale and d_template each within
    GRAD_*_REL of the tensor's largest |entry|."""
    kern, plain, plain_bwd = _window_fns(wa, banded)
    with torch.no_grad():
        out, pout = kern(qkv, scale, tmpl), plain(qkv, scale, tmpl)
    torch.cuda.synchronize()
    f32 = qkv.dtype == torch.float32
    e_fwd = (_close(out, pout, f32_atol, 0.0) if f32
             else _close(out, pout, BF16_TOL, BF16_TOL))
    got = wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded)
    want = plain_bwd(qkv, scale, tmpl, d_out)
    torch.cuda.synchronize()
    _fold(digest, out, *got)
    rel = GRAD_F32_REL if f32 else GRAD_BF16_REL
    parts = list(zip(("d_q", "d_k", "d_v"), got[0].chunk(3, -1),
                     want[0].chunk(3, -1)))
    parts += [("d_scale", got[1], want[1]), ("d_template", got[2], want[2])]
    errs = [(_rel_close(g, w, rel, f"{what} {name}"), w.float().abs().max().item())
            for name, g, w in parts]
    return (e_fwd, max(e for e, _ in errs),
            max(e / top if top else 0.0 for e, top in errs))


# the window launch counters by source: window_attention_dense.cu (B5 in
# bf16), window_attention_banded.cu (B6 in bf16), and the FMA sources
# window_attention.cu and window_attention_bwd.cu (f32)
WA_COUNTERS = ("dense_launches", "banded_launches", "dense_bwd_launches",
               "banded_bwd_launches", "launches", "bwd_launches")


def _window_counts(wa) -> tuple:
    """(dense fwd, banded fwd, dense bwd, banded bwd, FMA fwd, FMA bwd)."""
    return tuple(getattr(wa, c) for c in WA_COUNTERS)


def _zero_window(wa):
    for c in WA_COUNTERS:
        setattr(wa, c, 0)


def _sources_ran(wa, before, banded, dt, what, n=None):
    """A forward and a backward since ``before`` ran one kernel of each
    direction of the source their call takes (never another): bf16 banded
    ``window_attention_banded.cu``, bf16 dense ``window_attention_dense.cu``
    (at a grid it takes), else the FMA sources ``window_attention.cu`` and
    ``window_attention_bwd.cu``."""
    from tpat_tpu_torch.ops import window_attention as wa_mod

    got = tuple(a - b for a, b in zip(_window_counts(wa), before))
    if dt == torch.bfloat16 and banded:
        want = (0, 1, 0, 1, 0, 0)
    elif dt == torch.bfloat16 and wa_mod.dense_takes(n):
        want = (1, 0, 1, 0, 0, 0)
    else:
        want = (0, 0, 0, 0, 1, 1)
    if got != want:
        raise AssertionError(f"{what}: launches (dense fwd, banded fwd, dense "
                             f"bwd, banded bwd, FMA fwd, FMA bwd) {got}, "
                             f"expected {want}")


def window_vs_plain() -> dict:
    """Phase 12: the window kernels vs their plain versions at B=2."""
    from tpat_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    digest = hashlib.sha256()
    worst = {"B5 fwd": 0.0, "B5 bwd": 0.0, "B6 fwd": 0.0, "B6 bwd": 0.0}
    rel = {"B5": 0.0, "B6": 0.0}
    count = 0
    for h in (16, 4):
        for banded, ns in ((False, (64, 256)), (True, (128, 512))):
            for n in ns:
                for shift in ((0, 0), (2, 0)):
                    for dt in (torch.float32, torch.bfloat16):
                        what = (f"{'B6' if banded else 'B5'} H={h} N={n} "
                                f"shift={shift} {dt}")
                        args = _window_inputs(2, h, 32, (n // 8, 8), shift,
                                              banded, dt, gen)
                        before = _window_counts(wa)
                        ef, eb, rb = _compare_window(wa, *args, banded, what,
                                                     digest=digest)
                        _sources_ran(wa, before, banded, dt, what, n)
                        key = "B6" if banded else "B5"
                        worst[f"{key} fwd"] = max(worst[f"{key} fwd"], ef)
                        worst[f"{key} bwd"] = max(worst[f"{key} bwd"], eb)
                        if dt == torch.bfloat16:
                            rel[key] = max(rel[key], rb)
                        count += 1
    # at the clamp: a logit's rounding error is the cosine's times the scale,
    # so the f32 forward's atol grows with it from F32_ATOL at the initial
    # scale of 10 (on an H100 it reached 1.1e-5 at scales near 100)
    for banded, n in ((False, 256), (True, 512)):
        for dt in (torch.float32, torch.bfloat16):
            key = "B6" if banded else "B5"
            what = f"{key} H=16 N={n} shift=(2, 0) {dt} scale={SCALE_CLAMP:g}"
            args = _window_inputs(2, 16, 32, (n // 8, 8), (2, 0), banded, dt,
                                  gen, scale_value=SCALE_CLAMP)
            ef, eb, rb = _compare_window(wa, *args, banded, what,
                                         f32_atol=F32_ATOL * SCALE_CLAMP / 10.0,
                                         digest=digest)
            worst[f"{key} fwd"] = max(worst[f"{key} fwd"], ef)
            worst[f"{key} bwd"] = max(worst[f"{key} bwd"], eb)
            if dt == torch.bfloat16:
                rel[f"{key} at the clamp"] = rb
            count += 1
    # a template row with no live entry (uniform p over its window): the
    # tensor-core kernels keep its 16-row query block whole; and, banded,
    # finite entries in blocks off each row's own window (the banded
    # kernels' general loops, more than one live block a query block)
    edits = {"row 5 all -1e30": ((5, slice(None), -1e30),),
             "entries off the diagonal blocks": ((3, slice(100, 110), 0.5),
                                                 (200, slice(0, 20), -0.25))}
    for banded, n, label in ((False, 256, "row 5 all -1e30"),
                             (True, 512, "row 5 all -1e30"),
                             (True, 512, "entries off the diagonal blocks")):
        key = "B6" if banded else "B5"
        what = f"{key} H=16 N={n} shift=(2, 0) bf16, {label}"
        qkv, scale, tmpl, d_out = _window_inputs(
            2, 16, 32, (n // 8, 8), (2, 0), banded, torch.bfloat16, gen)
        for row, cols, value in edits[label]:
            tmpl[:, row, cols] = value
        before = _window_counts(wa)
        ef, eb, rb = _compare_window(wa, qkv, scale, tmpl, d_out, banded, what,
                                     digest=digest)
        _sources_ran(wa, before, banded, torch.bfloat16, what, n)
        worst[f"{key} fwd"] = max(worst[f"{key} fwd"], ef)
        worst[f"{key} bwd"] = max(worst[f"{key} bwd"], eb)
        rel[f"{key} {label}"] = rb
        count += 1
    log(f"window kernels vs plain at B=2, {count} cases (f32 and bf16): worst "
        "abs err " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
        + "; bf16 backward, worst err / max|plain| over its outputs: "
        + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
        + f"; the kernel outputs' sha256 {digest.hexdigest()}")
    return worst


# phase 14's two runs of each window backward at each of its geometries
WINDOW_REPEATS = {}


def _pretrain_counts(qa, wa) -> tuple:
    """(B1, B3 rows, B3 cols, B5 fwd, B6 fwd, B5 bwd, B6 bwd, FMA): B5 on
    window_attention_dense.cu, B6 on window_attention_banded.cu, FMA the
    launches of the f32 sources (none in a bf16 step)."""
    return (qa.launches, qa.bwd_rows_launches, qa.bwd_cols_launches,
            wa.dense_launches, wa.banded_launches, wa.dense_bwd_launches,
            wa.banded_bwd_launches, wa.launches + wa.bwd_launches)


# per-step launches (B1, B3 rows, B3 cols, B5 fwd, B6 fwd, B5 bwd, B6 bwd,
# FMA)
PRETRAIN_STEP_LAUNCHES = {"AudioSet": (12, 12, 12, 0, 16, 0, 16, 0),
                          "ESC-50": (12, 12, 12, 16, 0, 16, 0, 0)}


@contextlib.contextmanager
def _window_recording(wa, calls):
    """Route the window kernel launchers through a recorder: each launch
    appends (kind, B, N, 3C, dtype, H, banded).  They still count."""
    fwd, bwd = wa._forward_kernel, wa._backward_kernels

    def forward(qkv, scale, template, banded):
        calls.append(("wfwd", *qkv.shape, qkv.dtype, scale.shape[0], banded))
        return fwd(qkv, scale, template, banded)

    def backward(qkv, scale, template, d_out, banded):
        calls.append(("wbwd", *qkv.shape, qkv.dtype, scale.shape[0], banded))
        return bwd(qkv, scale, template, d_out, banded)

    wa._forward_kernel, wa._backward_kernels = forward, backward
    try:
        yield
    finally:
        wa._forward_kernel, wa._backward_kernels = fwd, bwd


def pretrain_path():
    """Phase 13: the MAE pretrain step at full width at each grid, every
    launch counted (per step and in all) and recorded; then the ms per step
    through the kernels and through 'xla', in turns.  Returns ({grid: launch
    counts}, {grid: one step's recorded launches}, {grid: step ms})."""
    from tpat_tpu_torch.cli import profile_pretrain as pp
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.ops import window_attention as wa

    counts, walks, step_ms = {}, {}, {}
    for tl, grid in PRETRAIN_GRIDS:
        cfg = pp.pretrain_config(tl)
        model, step = pp.build(cfg, seed=SEED)
        x = pp.synthetic_batch(cfg, PRETRAIN_BATCH, seed=SEED + 6)
        pos0 = (model.pos_embed.detach().clone(),
                model.decoder_pos_embed.detach().clone())
        impls = sorted({blk.impl for blk in model.decoder_blocks})
        calls, losses = [], []
        torch.cuda.synchronize()
        with _recording(qa, calls), _window_recording(wa, calls):
            qa.launches = qa.prefix_launches = 0  # the main path starts here
            qa.bwd_rows_launches = qa.bwd_cols_launches = 0
            _zero_window(wa)
            _gelu_zero()
            total = torch.zeros((), device="cuda")
            for i in range(PRETRAIN_STEPS):
                c0, i0 = _pretrain_counts(qa, wa), len(calls)
                new = step(total, i, x)
                torch.cuda.synchronize()
                losses.append((new - total).item())
                total = new
                got = tuple(a - b for a, b in zip(_pretrain_counts(qa, wa), c0))
                if got != PRETRAIN_STEP_LAUNCHES[grid]:
                    raise AssertionError(
                        f"{grid} step {i}: launches (B1, B3 rows, B3 cols, B5 "
                        f"fwd, B6 fwd, B5 bwd, B6 bwd, FMA) {got}, expected "
                        f"{PRETRAIN_STEP_LAUNCHES[grid]}")
                if walks.setdefault(grid, tuple(calls[i0:])) != tuple(calls[i0:]):
                    raise AssertionError(f"{grid}: steps launched at different "
                                         "geometries")
            counts[grid] = _pretrain_counts(qa, wa)  # the main path ends here
            c = counts[grid]
            _gelu_per_block(f"pretrain {grid}", _gelu_read("pretrain"),
                            (c[0] + c[3] + c[4], c[1] + c[5] + c[6]))
        if qa.prefix_launches:
            raise AssertionError(f"{grid}: the prefix kernel ran")
        if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"{grid}: losses {losses} not finite and falling")
        if not (torch.equal(model.pos_embed, pos0[0])
                and torch.equal(model.decoder_pos_embed, pos0[1])):
            raise AssertionError(f"{grid}: a frozen pos embed moved")
        del model, step
        torch.cuda.empty_cache()
        log(f"pretrain {grid} grid (target length {tl}, {cfg.num_patches} "
            f"patches, decoder {impls}): losses {[round(v, 5) for v in losses]}; "
            f"launches per step as expected; totals (B1, B3 rows, B3 cols, B5 "
            f"fwd, B6 fwd, B5 bwd, B6 bwd, FMA) {counts[grid]}")
        step_ms[grid] = pp.time_steps(tl, PRETRAIN_TIMED)
        torch.cuda.empty_cache()
        log(f"pretrain step b{PRETRAIN_BATCH} bf16 {grid} grid: kernels "
            f"{step_ms[grid]['kernels']:.3f} ms, xla "
            f"{step_ms[grid]['xla']:.3f} ms (mean of two turns of "
            f"{PRETRAIN_TIMED} steps)")
    return counts, walks, step_ms


def pretrain_kernels_vs_plain(walks) -> tuple:
    """Phase 14: each distinct launch geometry of the pretrain walks, kernel
    vs plain on a seeded input of that geometry (bf16, B=32), then kernel and
    plain timed in turns, the library call and the bound beside them.
    Returns ({grid: {kernel: per-step sums}}, {kernel: worst error})."""
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.ops import window_attention as wa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    per_call, worst = {}, {}
    for call in sorted({c for w in walks.values() for c in w}, key=str):
        backend = None  # the library call's SDPA backend, where it is chosen
        dev = None  # a window kernel's device ms (torch.profiler)
        if call[0] in ("fwd", "bwd"):
            kind, b, n, c3, dt, h, mode, extra, kv, has_ds = call
            if mode is not None or kv is not None or has_ds:
                raise AssertionError(f"pretrain launch with scores: {call}")
            qkv = torch.randn(b, n, c3, device="cuda", generator=gen).to(dt)
            bnd = work_bound(qkv_work(b, n, c3, h, 2, bwd=kind == "bwd"), dt)
            if kind == "fwd":
                name = "B1"
                err = max(_compare(qa, qkv, h, None, extra))
                with torch.no_grad():
                    k, p = _turns(lambda: qa.fused_qkv_attention(qkv, h, None, extra),
                                  lambda: qa.fused_qkv_attention_plain(qkv, h, None, extra))
                lib, _ = library_ms("qkv", qkv, h)
            else:
                name = "B3"
                d_out = torch.randn(b, n, c3 // 3, device="cuda",
                                    generator=gen).to(dt)
                out, lse = _saved(qa, qkv, h, None, extra, None)
                err = _compare_bwd(qa, qkv, d_out, None, h, None, extra, None,
                                   saved=(out, lse))
                k, p = _turns(
                    lambda: qa.fused_qkv_attention_bwd(
                        qkv, d_out, None, h, None, extra, out=out, lse=lse),
                    lambda: qa.fused_qkv_attention_bwd_plain(qkv, d_out, None, h, None, extra))
                lib, backend = library_ms("qkv", qkv, h, d_out=d_out)
        else:
            kind, b, n, c3, dt, h, banded = call
            name = ("B6" if banded else "B5") + (" fwd" if kind == "wfwd" else " bwd")
            qkv, scale, tmpl, d_out = _window_inputs(
                b, h, c3 // 3 // h, (n // 8, 8), (2, 0), banded, dt, gen)
            ef, eb, _ = _compare_window(wa, qkv, scale, tmpl, d_out, banded,
                                        f"{name} B={b} N={n}")
            kern, plain, plain_bwd = _window_fns(wa, banded)
            if kind == "wfwd":
                err = ef
                with torch.no_grad():
                    k, p = _turns(lambda: kern(qkv, scale, tmpl),
                                  lambda: plain(qkv, scale, tmpl))
                    dev = _device_ms(lambda: kern(qkv, scale, tmpl))
                lib, backend = library_ms("window", qkv, h, scale=scale,
                                          template=tmpl, banded=banded)
            else:
                err = eb
                k, p = _turns(
                    lambda: wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded),
                    lambda: plain_bwd(qkv, scale, tmpl, d_out))
                dev = _device_ms(
                    lambda: wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded))
                lib, backend = library_ms("window", qkv, h, scale=scale,
                                          template=tmpl, banded=banded,
                                          d_out=d_out)
                # d_template (d_band) and d_scale are sums over CTAs: the
                # same bits twice
                one = wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded)
                two = wa.window_attention_bwd(qkv, scale, tmpl, d_out, banded)
                tname = "d_band" if banded else "d_template"
                for label, x, y in zip(("d_qkv", "d_scale", tname), one, two):
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"{name} B={b} N={n}: {label} differs between "
                            "two runs")
                WINDOW_REPEATS[f"{name} B={b} N={n} H={h}"] = (
                    f"d_qkv, d_scale, {tname} equal bit for bit in two runs")
            bnd = work_bound(window_work(qkv, tmpl, banded, kind == "wbwd"),
                             dt)
        worst[name] = max(worst.get(name, 0.0), err)
        per_call[call] = (name, k, p, lib, bnd, backend, dev)
        log(f"{name} B={b} N={n} {dt}: kernel {k:.4f} ms"
            f"{f' (device {dev:.4f})' if dev is not None else ''}, plain "
            f"{p:.4f} ms, library {lib:.4f} ms"
            f"{f' ({backend})' if backend else ''}, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}); abs err {err:.3g}")
    sums = {}
    for grid, walk in walks.items():
        s = {}
        for call in walk:
            name, k, p, lib, (bms, by), backend, dev = per_call[call]
            e = s.setdefault(name, {"calls": 0, "ms": 0.0, "plain_ms": 0.0,
                                    "library_ms": 0.0, "bound": {},
                                    "backends": set(), "device_ms": 0.0})
            if backend is not None:
                e["backends"].add(backend)
            if dev is not None:
                e["device_ms"] += dev
            e["calls"] += 1
            e["ms"] += k
            e["plain_ms"] += p
            e["library_ms"] += lib
            e["bound"][by] = e["bound"].get(by, 0.0) + bms
        sums[grid] = s
        log(f"per b{PRETRAIN_BATCH} pretrain step, {grid} grid: " + "; ".join(
            f"{k} x{v['calls']} {v['ms']:.4f} ms (plain {v['plain_ms']:.4f}, "
            f"library {v['library_ms']:.4f}, bound "
            f"{sum(v['bound'].values()):.4f})" for k, v in s.items()))
    return sums, worst


def pretrain_step_f32():
    """Phase 15: one f32 pretrain step's loss and gradients at each grid,
    the window kernels ('auto') vs 'xla', from the same seeded weights and
    batch and the same step generator, so the same masks and dropout."""
    from tpat_tpu_torch.cli import profile_pretrain as pp
    from tpat_tpu_torch.engine import pretrain

    for tl, grid in PRETRAIN_GRIDS:
        res = {}
        for impl in ("auto", "xla"):
            cfg = pp.pretrain_config(tl, impl, "float32")
            model, _ = pp.build(cfg, seed=SEED)
            model.train()
            x = pp.synthetic_batch(cfg, STEP_BATCH_F32, seed=SEED + 7)
            gen = pretrain.step_generator(SEED, 0, "cuda")
            loss, _, _ = model(x, pp.MASK_RATIO, generator=gen,
                               deterministic=False)
            named = [(n, p) for n, p in model.named_parameters()
                     if p.requires_grad]
            grads = torch.autograd.grad(loss, [p for _, p in named])
            res[impl] = (loss.item(), dict(zip((n for n, _ in named), grads)),
                         sorted({blk.impl for blk in model.decoder_blocks}))
            del model
            torch.cuda.empty_cache()
        (lk, gk, ik), (lx, gx, _) = res["auto"], res["xla"]
        if not abs(lk - lx) <= STEP_LOSS_RTOL * abs(lx):
            raise AssertionError(f"{grid}: f32 loss {lk} vs {lx} (xla)")
        worst = 0.0
        for k, g in gx.items():
            err = (gk[k] - g).abs().max().item()
            scale = g.abs().max().item()
            if k.endswith("meta_mlp.fc2.bias"):
                # the sum of d(template): zero in exact arithmetic, noise in
                # both, held by size (tests/test_window_attention.py:61-68)
                if not max(scale, gk[k].abs().max().item()) < 5e-3:
                    raise AssertionError(f"{grid}: {k} not noise-sized")
                continue
            if not err <= GRAD_F32_REL * scale:
                raise AssertionError(f"{grid}: grad {k} err {err:.3g} > "
                                     f"{GRAD_F32_REL} x {scale:.3g}")
            worst = max(worst, err / scale if scale else 0.0)
        log(f"f32 pretrain step, {grid} grid, b{STEP_BATCH_F32}: decoder {ik} "
            f"loss {lk:.7f} vs {lx:.7f} (xla); {len(gx)} parameter gradients, "
            f"worst err / max|grad| {worst:.3g}")


# ---------------------------------------------------------------------------
# Phases 16-19: the LayerNorm kernels (B4) on the finetune and serving paths,
# and the probes (P1-P3)
# ---------------------------------------------------------------------------


def _ln_inputs(m, d, dt, gen):
    """x ~ N(0, 1) in dt, w ~ 1 + N(0, 0.1^2), b ~ N(0, 0.1^2) (f32), dy ~
    N(0, 1) in dt."""
    x = torch.randn(m, d, device="cuda", generator=gen).to(dt)
    w = 1.0 + 0.1 * torch.randn(d, device="cuda", generator=gen)
    b = 0.1 * torch.randn(d, device="cuda", generator=gen)
    dy = torch.randn(m, d, device="cuda", generator=gen).to(dt)
    return x, w, b, dy


def _compare_ln(ln, x, w, b, dy) -> tuple:
    """Kernel vs plain on one input, forward (y, mu, rstd) and backward
    (dx, dw, db from the plain mu and rstd): (forward abs err, backward abs
    err)."""
    what = f"layernorm M={x.shape[0]} D={x.shape[1]} {x.dtype}"
    with torch.no_grad():
        got = ln.layernorm_fwd(x, w, b, LN_EPS)
        want = ln.layernorm_fwd_plain(x, w, b, LN_EPS)
        got_b = ln.layernorm_bwd(x, w, want[1], want[2], dy)
        want_b = ln.layernorm_bwd_plain(x, w, want[1], want[2], dy)
    torch.cuda.synchronize()
    f32 = x.dtype == torch.float32
    tol = (F32_ATOL, 0.0) if f32 else (BF16_TOL, BF16_TOL)
    e_fwd = max(_close(g, p, *tol) for g, p in zip(got, want))
    rel = GRAD_F32_REL if f32 else GRAD_BF16_REL
    e_bwd = max(_rel_close(g, p, rel, f"{what} {name}")
                for name, g, p in zip(("dx", "dw", "db"), got_b, want_b))
    return e_fwd, e_bwd


def layernorm_vs_plain() -> dict:
    """Phase 16: the LayerNorm kernels vs their plain versions at
    M in LN_ROWS, every width of ``ops.layernorm.WIDTHS``, f32 and bf16."""
    from tpat_tpu_torch.ops import layernorm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    worst = {"fwd": 0.0, "bwd": 0.0}
    count = 0
    for m in LN_ROWS:
        for d in ln.WIDTHS:
            for dt in (torch.float32, torch.bfloat16):
                ef, eb = _compare_ln(ln, *_ln_inputs(m, d, dt, gen))
                worst = {"fwd": max(worst["fwd"], ef),
                         "bwd": max(worst["bwd"], eb)}
                count += 1
    log(f"layernorm kernels vs plain, {count} cases (M {list(LN_ROWS)}, D "
        f"{list(ln.WIDTHS)}, f32 and bf16): worst abs err forward "
        f"{worst['fwd']:.3g}, backward {worst['bwd']:.3g}")
    return worst


@contextlib.contextmanager
def _ln_recording(ln, calls):
    """Route the LayerNorm kernel launchers through a recorder: each launch
    appends (kind, M, D, dtype).  They still count."""
    fwd, bwd = ln._forward_kernel, ln._backward_kernel

    def forward(x2, w, b, eps):
        calls.append(("lnfwd", *x2.shape, x2.dtype))
        return fwd(x2, w, b, eps)

    def backward(x2, w, mu, rstd, dy):
        calls.append(("lnbwd", *x2.shape, x2.dtype))
        return bwd(x2, w, mu, rstd, dy)

    ln._forward_kernel, ln._backward_kernel = forward, backward
    try:
        yield
    finally:
        ln._forward_kernel, ln._backward_kernel = fwd, bwd


def layernorm_serving(cfg, out_dir) -> tuple:
    """Phase 17, serving: the artifact of phase 4 loaded with
    ``use_fused_layernorm=True`` answers the same requests, 24 LayerNorm
    launches per bucket forward (counted and recorded); then ms per b128
    forward with the flag and without, in turns (off, on, on, off).
    Returns (launches, every recorded launch of every bucket, one b128
    forward's recorded launches)."""
    from tpat_tpu_torch.ops import layernorm as ln
    from tpat_tpu_torch.utils.serving import load_forward

    on, _ = load_forward(out_dir, device="cuda", cfg=dataclasses.replace(
        cfg, use_fused_layernorm=True))
    off, _ = load_forward(out_dir, device="cuda", cfg=cfg)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    requests = {n: torch.randn(n, 1, 512, 128, device="cuda", generator=gen)
                for n in REQUESTS}
    calls, walk = [], None
    torch.cuda.synchronize()
    with _ln_recording(ln, calls):
        ln.launches = ln.bwd_launches = 0  # the main path starts here
        for n, x in requests.items():
            i0 = len(calls)
            y = on(x)
            torch.cuda.synchronize()
            forwards = math.ceil(n / BUCKETS[-1])
            if len(calls) - i0 != 24 * forwards:
                raise AssertionError(
                    f"request of {n}: {len(calls) - i0} layernorm launches, "
                    f"expected {24 * forwards} ({forwards} bucket forwards x "
                    "12 blocks x 2)")
            if y.shape != (n, 50) or not torch.isfinite(y).all():
                raise AssertionError(f"request of {n}: bad logits")
            if n == BUCKETS[-1]:
                walk = tuple(calls[i0:])
        launches = ln.launches  # the main path ends here
    if walk is None:
        raise AssertionError(f"no request filled the b{BUCKETS[-1]} bucket")
    if ln.bwd_launches or launches != len(calls):
        raise AssertionError(f"serving: {launches} forward and "
                             f"{ln.bwd_launches} backward layernorm launches, "
                             f"{len(calls)} recorded")
    x = requests[128]
    ms = {}
    for name, f in (("off", off), ("on", on), ("on", on), ("off", off)):
        ms.setdefault(name, []).append(_time_ms(lambda: f(x), iters=10))
    on_ms, off_ms = sum(ms["on"]) / 2, sum(ms["off"]) / 2
    log(f"serving with use_fused_layernorm: {launches} layernorm launches "
        f"(24 per bucket forward); b128 bf16 forward {on_ms:.3f} ms with the "
        f"flag, {off_ms:.3f} ms without ({128 / on_ms * 1e3:.1f} vs "
        f"{128 / off_ms * 1e3:.1f} clips/s; turns {ms})")
    return launches, tuple(calls), walk


def layernorm_training(sd) -> tuple:
    """Phase 17, training: phase 8's five epochs with
    ``use_fused_layernorm=True``, 24 forward and 24 backward LayerNorm
    launches per step asserted and every launch's (M, D) recorded (the
    counted main path); then in turns without the flag (asserting no
    launch), with it, with it, without, for the ms per step.  Returns
    ((forward, backward) launches, {epoch label: one step's launches})."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.ops import layernorm as ln

    cfg, tc = _train_configs("bfloat16", 0.1)
    batches = profile_train.synthetic_batches(
        cfg, profile_train.TRAIN_BATCH, 2, SEED + 4)

    def counts():
        return ln.launches, ln.bwd_launches

    def run(flag, count):
        calls = []
        with _ln_recording(ln, calls):
            if count:
                ln.launches = ln.bwd_launches = 0  # the main path starts here
            steps, losses = _run_epochs(
                dataclasses.replace(cfg, use_fused_layernorm=flag), tc, sd,
                batches, counts, calls, f"use_fused_layernorm={flag}")
            total = counts()  # the main path ends here
        want = LN_STEP_LAUNCHES if flag else (0, 0)
        for i, (_, got, _) in enumerate(steps):
            if got != want:
                raise AssertionError(
                    f"use_fused_layernorm={flag}, step {i}: layernorm "
                    f"launches (fwd, bwd) {got}, expected {want}")
        return steps, losses, total

    steps, losses, launches = run(True, True)
    walks = {label: steps[2 * i][2] for i, label in enumerate(EPOCH_LABELS)}
    log(f"training with use_fused_layernorm: losses per epoch "
        f"{[round(v, 4) for v in losses]}; layernorm launches (fwd, bwd) "
        f"{LN_STEP_LAUNCHES} per step as expected, totals {launches}")
    off1, _, _ = run(False, False)
    on1, _, _ = run(True, False)
    on2, _, _ = run(True, False)
    off2, _, _ = run(False, False)
    for epoch, label in enumerate(EPOCH_LABELS):
        k = [s[2 * epoch + 1][0] for s in (on1, on2)]
        p = [s[2 * epoch + 1][0] for s in (off1, off2)]
        log(f"train step b128 bf16, epoch {epoch} ({label}): "
            f"use_fused_layernorm {sum(k) / 2:.1f} ms, plain LayerNorm "
            f"{sum(p) / 2:.1f} ms (second steps {[round(v, 1) for v in k]} / "
            f"{[round(v, 1) for v in p]})")
    return launches, walks


def layernorm_library(x, w, b, dy=None):
    """The yardstick, as a call: ``F.layer_norm`` on the f32 cast followed
    by the cast to x's dtype (the function the kernel computes), or with
    ``dy`` its autograd backward alone.  The port never calls it."""
    d = x.shape[-1]
    if dy is None:
        return lambda: F.layer_norm(x.float(), (d,), w, b, LN_EPS).to(x.dtype)
    xr, wr, br = (t.detach().requires_grad_() for t in (x, w, b))
    out = F.layer_norm(xr.float(), (d,), wr, br, LN_EPS).to(x.dtype)
    return lambda: torch.autograd.grad(out, (xr, wr, br), dy, retain_graph=True)


def _device_ms(fn, iters=20) -> float:
    """Device ms per call of ``fn``: the summed durations of the CUDA kernels
    it launches over ``iters`` calls (``torch.profiler``), without the
    host's gaps between them.  For calls of a few tens of microseconds,
    whose CUDA-event times include the host's launch rate."""
    from torch.profiler import ProfilerActivity, profile

    from tpat_tpu_torch.cli.profile_forward import kernel_rows

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(r["device_ms"] for r in kernel_rows(prof, iters))


def ln_work(m, d, itemsize, bwd) -> tuple:
    """(bytes, f32 operations) a LayerNorm forward or backward needs: x read
    and y written (the backward reads x and dy and writes dx), mu and rstd
    (f32) written or read, the (D,) f32 parameters read and, backward, dw
    and db written.  About 8 operations per element forward, 12 backward."""
    if bwd:
        return 3 * m * d * itemsize + 8 * m + 12 * d, 12 * m * d
    return 2 * m * d * itemsize + 8 * m + 8 * d, 8 * m * d


def layernorm_at_path(geometries, timed) -> tuple:
    """Phase 18: each recorded LayerNorm geometry (every serving bucket and
    training step), kernel vs plain on a seeded input; those in ``timed``
    (B=128) then both timed with CUDA events in turns (each call through its
    wrapper), beside the bound and the library call, and the device time of
    each of the three (``_device_ms``).  Returns ({timed geometry: (ms,
    plain ms, library ms, bound, device ms of the three)}, worst abs err)."""
    from tpat_tpu_torch.ops import layernorm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    per, worst = {}, 0.0
    timed = set(timed)
    for call in sorted(set(geometries) | timed, key=str):
        kind, m, d, dt = call
        x, w, b, dy = _ln_inputs(m, d, dt, gen)
        ef, eb = _compare_ln(ln, x, w, b, dy)
        bwd = kind == "lnbwd"
        worst = max(worst, eb if bwd else ef)
        if call not in timed:
            continue
        _, mu, rstd = ln.layernorm_fwd_plain(x, w, b, LN_EPS)
        if bwd:
            kern = lambda: ln.layernorm_bwd(x, w, mu, rstd, dy)  # noqa: E731
            plain = lambda: ln.layernorm_bwd_plain(x, w, mu, rstd, dy)  # noqa: E731
        else:
            kern = lambda: ln.layernorm_fwd(x, w, b, LN_EPS)  # noqa: E731
            plain = lambda: ln.layernorm_fwd_plain(x, w, b, LN_EPS)  # noqa: E731
        library = layernorm_library(x, w, b, dy if bwd else None)
        with torch.no_grad():
            k, p = _turns(kern, plain)
            dev = [_device_ms(f) for f in (kern, plain)]
        with torch.no_grad() if not bwd else contextlib.nullcontext():
            lib = _time_ms(library)
            dev.append(_device_ms(library))
        nbytes, ops = ln_work(m, d, x.element_size(), bwd)
        bnd = bound_ms(nbytes, ops, torch.float32)
        per[call] = (k, p, lib, bnd, tuple(dev))
        log(f"layernorm {'bwd' if bwd else 'fwd'} M={m} D={d} {dt}: kernel "
            f"{k:.4f} ms, plain {p:.4f} ms, library {lib:.4f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); device time kernel {dev[0]:.4f}, "
            f"plain {dev[1]:.4f}, library {dev[2]:.4f} ms; abs err "
            f"{eb if bwd else ef:.3g}")
    log(f"layernorm kernels vs plain at {len(set(geometries) | timed)} "
        f"recorded geometries ({len(timed)} timed): worst abs err {worst:.3g}")
    return per, worst


DEVICE_KEYS = ("device_ms", "plain_device_ms", "library_device_ms")


def _sum_walk(per, walk) -> dict:
    """A walk's per-call times summed: ms, plain_ms, library_ms, bound and
    the three device times."""
    s = dict.fromkeys(("ms", "plain_ms", "library_ms") + DEVICE_KEYS, 0.0)
    s["bound"] = {}
    for call in walk:
        k, p, lib, (bms, by), dev = per[call]
        for key, v in zip(("ms", "plain_ms", "library_ms") + DEVICE_KEYS,
                          (k, p, lib) + dev):
            s[key] += v
        s["bound"][by] = s["bound"].get(by, 0.0) + bms
    return s


def ln_matmul_library_ms(x, g, b, w) -> float:
    """The yardstick: ms per call, by CUDA events, of ``F.layer_norm`` (f32
    statistics, cast to x's dtype) followed by ``torch.matmul``.  The port
    never calls it."""
    with torch.no_grad():
        return _time_ms(lambda: torch.matmul(F.layer_norm(
            x.float(), (x.shape[1],), g, b, LN_EPS).to(x.dtype), w))


def _compare_variant(p1, qkv, variant) -> tuple:
    """P1 kernel vs plain on one input: out within F32_ATOL (f32) or
    BF16_TOL for the normalised variants, within UNNORM_F32_REL or
    GRAD_BF16_REL of the largest |entry| for noexp and mmonly; colsum within
    the score tolerance for 'full' and exactly zero otherwise.  Returns (the
    worst abs err, the kernel's out, its colsum)."""
    what = f"P1 {variant} B={qkv.shape[0]} N={qkv.shape[1]} {qkv.dtype}"
    with torch.no_grad():
        out, colsum = p1.variant_attention(qkv, variant)
        pout, pcol = p1.variant_attention_plain(qkv, variant)
    torch.cuda.synchronize()
    f32 = qkv.dtype == torch.float32
    if variant in ("noexp", "mmonly"):
        err = _rel_close(out, pout, UNNORM_F32_REL if f32 else GRAD_BF16_REL,
                         what)
    else:
        err = (_close(out, pout, F32_ATOL, 0.0) if f32
               else _close(out, pout, BF16_TOL, BF16_TOL))
    if variant == "full":
        err = max(err, _close(colsum, pcol, SCORE_ATOL, SCORE_RTOL))
    elif colsum.shape != pcol.shape or colsum.any():
        raise AssertionError(f"{what}: colsum is not zero")
    return err, out, colsum


def sass_check(name: str, kernel: str, needles=("HGMMA", "UTMALDG")):
    """Counts of ``needles`` in the SASS of ``kernel`` (a substring of its
    mangled name) in the built ``csrc/<name>.cu``, by cuobjdump; raises if
    one is missing.  "not checked" where the toolkit has no cuobjdump."""
    from tpat_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log(f"SASS of {kernel}: not checked (no cuobjdump)")
        return "not checked"
    sass = subprocess.run([tool, "-sass", str(_build.build(name))],
                          capture_output=True, text=True, check=True).stdout
    found = [f for f in sass.split("Function : ")[1:]
             if kernel in f.split(maxsplit=1)[0]]
    if len(found) != 1:
        raise AssertionError(f"no single SASS function of {kernel}")
    counts = {needle: found[0].count(needle) for needle in needles}
    log(f"SASS of {kernel}: {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"{kernel}: SASS lacks one of {needles}: {counts}")
    return counts


def _bf16_ulps(t):
    """bf16 values as integers in the order of their values, so that
    neighbouring values differ by 1 (-0 and +0 both 0)."""
    v = t.contiguous().view(torch.int16).int()
    return torch.where(v < 0, -(v & 0x7FFF), v)


def ln_matmul_identity(p3) -> dict:
    """P3 in bf16 with w = I: the product is y itself, so the output is the
    kernel's LayerNorm rounded to bf16 once.  Held to ``p3.ln`` within one
    bf16 ulp at the scale of the larger of |y| and |(x - mu) rstd g|: the
    statistics are summed in another order than torch's (rstd moves by an
    f32 ulp), which moves y by a few f32 ulps of that term, many bf16 ulps
    of a y near 0 where b cancels it.  Logs and returns the share of
    entries that differ and how far, in bf16 ulps of y itself, over a few
    seeded inputs."""
    from tpat_tpu_torch.ops.layernorm import layernorm_fwd_plain  # p3.ln's

    m, k, seeds = P3_IDENTITY
    eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
    out = dict.fromkeys(("entries", "differ", "over_one_ulp_of_y",
                         "max_ulps_of_y"), 0)
    out["max_abs_y_over_one_ulp"] = 0.0
    for seed in range(SEED + 14, SEED + 14 + seeds):
        x, g, b, _ = p3.inputs(seed, m, k, k, torch.bfloat16)
        with torch.no_grad():
            got = p3.ln_matmul(x, g, b, eye)
            want, mu, rstd = layernorm_fwd_plain(x, g, b, p3.EPS)
        torch.cuda.synchronize()
        ulps = (_bf16_ulps(got) - _bf16_ulps(want)).abs()
        scale = torch.maximum(want.float().abs(),
                              ((x.float() - mu) * rstd * g).abs())
        ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
        err = (got.float() - want.float()).abs()
        if not torch.isfinite(got.float()).all() or (err > ulp).any():
            raise AssertionError(
                f"P3 w = I, seed {seed}: {int((err > ulp).sum())} entries "
                "further than one bf16 ulp of max(|y|, |(x - mu) rstd g|) "
                "from p3.ln")
        over = ulps > 1
        out["entries"] += got.numel()
        out["differ"] += int((ulps > 0).sum())
        out["over_one_ulp_of_y"] += int(over.sum())
        out["max_ulps_of_y"] = max(out["max_ulps_of_y"], int(ulps.max()))
        if over.any():
            out["max_abs_y_over_one_ulp"] = max(
                out["max_abs_y_over_one_ulp"],
                want.float().abs()[over].max().item())
    out["share_differing"] = out["differ"] / out["entries"]
    log(f"P3 w = I, M={m}, K=N={k}, {seeds} inputs: {out}")
    return out


def _same_bits(got, want, what):
    if not torch.equal(got, want):
        raise AssertionError(
            f"{what}: not the same bits (max abs diff "
            f"{(got.float() - want.float()).abs().max().item():.3g})")


def probe_work(b, n, itemsize, variant) -> tuple:
    """(bytes, FLOPs) of one P1/P2 call at C = 768, H = 12: qkv read, out
    written, the f32 colsum written for 'full'; 4 N^2 D FLOPs per (sample,
    head)."""
    nbytes = itemsize * b * n * 4 * 768 + (4 * b * 12 * n if variant == "full"
                                           else 0)
    return nbytes, 4 * b * 12 * n * n * 64


def probes_vs_plain() -> tuple:
    """Phase 19: P1's six variants vs plain at B=2 (N 33 and 257, f32 and
    bf16) and B=128 (N 257 and 181, bf16); P2's nine geometries vs plain at
    B=2 (N 33 and 257) and B=128 (N 257 and 181), bf16; P3 vs plain at
    ``P3_CASES``, each bf16 case launched three more times for the same
    bits, then with w = I (``ln_matmul_identity``).  In bf16 P1/P2 run
    B1's wgmma body, so the nine P2 geometries must give P1 'noscore''s
    bits at each input, and at B=128 P1 'full' and 'noscore' B1's out bits
    (``fused_qkv_attention`` with patch_mean scores at extra 1 and
    without), 'full''s column sums B1's scores once reduced as B1's
    wrapper reduces them.  Then each at the probe's shapes (B=128,
    N=257; P3's M, K, N), kernel and plain timed in turns beside the bound
    and the library call.  Returns ({probe: worst abs err}, {probe: times}, P3's w = I
    record)."""
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.probes import probe_attn_grouping as p2
    from tpat_tpu_torch.probes import probe_attn_softmax as p1
    from tpat_tpu_torch.probes import probe_ln_matmul as p3

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    bf16 = torch.bfloat16
    worst = {"P1": 0.0, "P2": 0.0, "P3": 0.0}
    inputs = {}
    for b, n, dt in ((2, 33, torch.float32), (2, 33, bf16),
                     (2, 257, torch.float32), (2, 257, bf16), (128, 257, bf16),
                     (128, 181, bf16)):
        qkv = torch.randn(b, n, 3 * p1.C, device="cuda", generator=gen).to(dt)
        inputs[b, n, dt] = qkv
        outs, cols = {}, {}
        for variant in p1.VARIANTS:
            err, outs[variant], cols[variant] = _compare_variant(p1, qkv,
                                                                 variant)
            worst["P1"] = max(worst["P1"], err)
        if dt == bf16:
            what = f"B={b} N={n}"
            with torch.no_grad():
                want = p2.grouped_attention_plain(qkv)
                for rows in p2.ROWS:
                    for heads in p2.HEADS:
                        got = p2.grouped_attention(qkv, rows, heads)
                        worst["P2"] = max(worst["P2"], _close(
                            got, want, BF16_TOL, BF16_TOL))
                        _same_bits(got, outs["noscore"],
                                   f"P2 {rows} rows, {heads} heads vs P1 "
                                   f"noscore, {what}")
                if b == 128:
                    for variant, mode in (("noscore", None),
                                          ("full", "patch_mean")):
                        b1, scores = qa.fused_qkv_attention(qkv, p1.H, mode, 1)
                        _same_bits(outs[variant], b1,
                                   f"P1 {variant} vs B1 ({mode}), {what}")
                    _same_bits(qa.reduce_scores(cols["full"][:, :, 0],
                                                "patch_mean", n, 1), scores,
                               f"P1 full's column sums vs B1's scores, {what}")
    for m, k, n, dt in P3_CASES:
        x, g, b, w = p3.inputs(SEED + 13, m, k, n, dt)
        with torch.no_grad():
            got, want = p3.ln_matmul(x, g, b, w), p3.ln_matmul_plain(x, g, b, w)
            again = [p3.ln_matmul(x, g, b, w) for _ in range(3 if dt == bf16
                                                             else 0)]
        torch.cuda.synchronize()
        tol = (F32_ATOL, F32_ATOL) if dt == torch.float32 else (BF16_TOL, BF16_TOL)
        worst["P3"] = max(worst["P3"], _close(got, want, *tol))
        for i, a in enumerate(again):
            _same_bits(a, got, f"P3 launch {i + 2} at ({m}, {k}, {n})")
    identity = ln_matmul_identity(p3)
    log(f"probes vs plain: 36 P1 cases (6 variants), 36 P2 cases (9 "
        f"geometries), {len(P3_CASES)} P3 cases (each bf16 one the same bits "
        "over four launches): worst abs err " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items()) + "; the same bits: "
        "P2's nine geometries and P1 noscore at each of 4 bf16 inputs, P1 "
        "full and noscore and B1 (out; full's scores) at B=128, N 257 and "
        "181")

    times = {}
    qkv = inputs[128, 257, bf16]
    attention, _ = library_ms("qkv", qkv, p1.H)  # softmax attention, no scores
    for variant in p1.VARIANTS:
        with torch.no_grad():
            k, p = _turns(lambda: p1.variant_attention(qkv, variant),
                          lambda: p1.variant_attention_plain(qkv, variant))
        times[f"P1 {variant}"] = (
            k, p, attention if variant == "noscore" else None,
            bound_ms(*probe_work(128, 257, 2, variant), bf16))
    with torch.no_grad():
        plain = _time_ms(lambda: p2.grouped_attention_plain(qkv))
        for rows in p2.ROWS:
            for heads in p2.HEADS:
                k = _time_ms(lambda: p2.grouped_attention(qkv, rows, heads))
                times[f"P2 {rows} rows, {heads} heads"] = (
                    k, plain, attention,
                    bound_ms(*probe_work(128, 257, 2, None), bf16))
    x, g, b, w = p3.inputs(SEED + 13, p3.M, p3.K, p3.N, bf16)
    with torch.no_grad():
        k, p = _turns(lambda: p3.ln_matmul(x, g, b, w),
                      lambda: p3.ln_matmul_plain(x, g, b, w))
    m, kk, n = p3.M, p3.K, p3.N
    times["P3"] = (k, p, ln_matmul_library_ms(x, g, b, w),
                   bound_ms(2 * (m * kk + kk * n + m * n) + 8 * kk,
                            2 * m * kk * n, bf16))
    for key, (k, p, lib, (bms, by)) in times.items():
        log(f"{key} at the probe's shapes: kernel {k:.4f} ms, plain {p:.4f} "
            f"ms, library {lib} ms, bound {bms:.4f} ms ({by})")
    return worst, times, identity


def probe_mains() -> dict:
    """Phase 19, the probes' main path: each probe's ``main()`` once with
    PROBE_ITERS timed calls per row; returns each probe's launches."""
    from tpat_tpu_torch.probes import probe_attn_grouping as p2
    from tpat_tpu_torch.probes import probe_attn_softmax as p1
    from tpat_tpu_torch.probes import probe_ln_matmul as p3

    p1.launches = p2.launches = p3.launches = 0  # the main path starts here
    for probe in (p1, p2, p3):
        probe.main(iters=PROBE_ITERS)
    launches = {"P1": p1.launches, "P2": p2.launches, "P3": p3.launches}
    log(f"probe mains: launches {launches}")  # the main path ended above
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe launched no kernel: {launches}")
    return launches


# Phase 20: scripts/ft_esc50.sh through the port's finetune CLI, on a
# seeded ESC-50-shaped corpus (50 classes, 5-s clips at 16 kHz: 498 fbank
# frames, padded to the preset's 512)
FINETUNE_CLASSES = 50
FINETUNE_BATCH = 128  # ft_esc50.sh's batch_size
FINETUNE_CLIPS = (256, 200)  # train: 2 steps at b128; eval: 128 + a ragged 72
FINETUNE_SECONDS = 5.0
FINETUNE_SEED = 12  # ft_esc50.sh's first seed
# ft_esc50.sh's epoch counts cut to four epochs: dense (2D masking), anneal
# at the cosine's t = 0 (rates 1.0: the dense step), anneal at rates 0.85
# (the hybrid step at bucket 0.9), static.  One anneal epoch alone would be
# the t = 0 point only, which launches no prefix kernel.
FINETUNE_FLAGS = ("--epochs", "4", "--shrink_start_epoch", "1",
                  "--shrink_epochs", "2", "--first_eval_ep", "0",
                  "--warmup_epochs", "1")
FINETUNE_PHASES = ["dense", "anneal", "anneal", "static"]
# phase 8's walk of the same step kind, for each finetune epoch
FINETUNE_WALKS = (EPOCH_LABELS[0], EPOCH_LABELS[1], BUCKET_09, EPOCH_LABELS[4])


def finetune_corpus(root, pretrained_cfg):
    """Seeded WAVs (a class tone with harmonics, a random gain and noise),
    the JSON manifests, the label CSV and a seeded ViT-B 'pretrained' .pth
    at the AudioSet grid (513 pos_embed rows, a 527-class head), so the
    CLI's import crops the pos embed and drops the head."""
    import numpy as np

    from tpat_tpu_torch.data.wav import save_wav
    from tpat_tpu_torch.models.vit import AudioViT

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(FINETUNE_SEED)
    sr = 16000
    t = np.arange(int(FINETUNE_SECONDS * sr)) / sr
    paths = {}
    for split, n in zip(("train", "eval"), FINETUNE_CLIPS):
        entries = []
        for i in range(n):
            c = int(rng.integers(FINETUNE_CLASSES))
            f0 = 150.0 + 40.0 * c
            w = sum(np.sin(2 * math.pi * f0 * k * t + rng.uniform(0, 6.3)) / k
                    for k in (1, 2, 3))
            w = 0.2 * rng.uniform(0.5, 1.5) * w + 0.05 * rng.normal(size=t.size)
            path = os.path.join(root, f"{split}{i:03d}.wav")
            save_wav(path, w.astype(np.float32), sr)
            entries.append({"wav": path, "labels": f"/m/c{c:02d}"})
        paths[split] = os.path.join(root, f"esc_{split}_data.json")
        with open(paths[split], "w") as f:
            json.dump({"data": entries}, f)
    paths["labels"] = os.path.join(root, "esc_class_labels_indices.csv")
    with open(paths["labels"], "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(FINETUNE_CLASSES):
            f.write(f'{c},/m/c{c:02d},"class {c}"\n')
    model = AudioViT(pretrained_cfg)
    paths["pretrained"] = os.path.join(root, "pretrained.pth")
    torch.save({"model": sharpened_state_dict(model, FINETUNE_SEED)},
               paths["pretrained"])
    return paths


def finetune_argv(paths, out):
    """ft_esc50.sh's flags for one fold and seed, with FINETUNE_FLAGS'
    epoch counts."""
    return [
        "--dataset", "esc50", "--nb_classes", str(FINETUNE_CLASSES),
        "--data_train", paths["train"], "--data_eval", paths["eval"],
        "--label_csv", paths["labels"],
        "--batch_size", str(FINETUNE_BATCH), "--blr", "1e-3", "--min_lr", "1e-5",
        "--base_keep_rate", "0.7", "--drop_loc", "(3, 6, 9)",
        "--mask_t_prob", "0.3", "--mask_f_prob", "0.3",
        "--freqm", "24", "--timem", "96", "--roll_mag_aug", "true",
        "--audioset_pretrained_model_path", paths["pretrained"],
        "--seed", str(FINETUNE_SEED), "--output_dir", out,
        "--result_path", os.path.join(out, "train_result.txt"),
        *FINETUNE_FLAGS,
    ]


def _walk_counts(walk) -> tuple:
    """(fwd, prefix fwd, bwd rows, bwd cols) launches of a recorded walk."""
    fwd = sum(1 for c in walk if c[0] == "fwd" and c[8] is None)
    prefix = sum(1 for c in walk if c[0] == "fwd" and c[8] is not None)
    bwd = sum(1 for c in walk if c[0] == "bwd")
    return (fwd, prefix, bwd, bwd)


@contextlib.contextmanager
def _finetune_recording(qa, calls, epochs, evals):
    """Time and count the CLI's train steps and eval forwards without
    touching the CLI: ``TrainModule.train_epoch`` gets its batches
    through a wrapper that times the wait for each batch from the loader,
    then the step (synchronised), with its launch counts and recorded
    launches; ``make_eval_step``'s step is timed and counted per forward."""
    from tpat_tpu_torch.engine import evaluate as eval_lib
    from tpat_tpu_torch.engine import train as train_lib

    def counts():
        return _counts(qa)

    def waited(batches, rec):
        it = iter(batches)
        while True:
            t = time.perf_counter()
            try:
                x, y = next(it)
            except StopIteration:
                return
            rec["wait_ms"].append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            c0, i0, t0 = counts(), len(calls), time.perf_counter()
            yield x, y
            torch.cuda.synchronize()
            rec["steps"].append(((time.perf_counter() - t0) * 1e3,
                                 tuple(a - b for a, b in zip(counts(), c0)),
                                 tuple(calls[i0:])))

    train_epoch = train_lib.TrainModule.train_epoch
    make_eval_step = eval_lib.make_eval_step

    def timed_epoch(self, state, batches, epoch, **kw):
        rec = {"epoch": epoch, "wait_ms": [], "steps": []}
        t0 = time.perf_counter()
        out = train_epoch(self, state, waited(batches, rec), epoch, **kw)
        torch.cuda.synchronize()
        rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
        epochs.append(rec)
        return out

    def timed_eval_step(model, *a, **kw):
        step = make_eval_step(model, *a, **kw)

        def timed(x):
            torch.cuda.synchronize()
            c0, t0 = counts(), time.perf_counter()
            out = step(x)
            torch.cuda.synchronize()
            evals.append(((time.perf_counter() - t0) * 1e3,
                          tuple(a - b for a, b in zip(counts(), c0)),
                          x.shape[0]))
            return out

        return timed

    train_lib.TrainModule.train_epoch = timed_epoch
    eval_lib.make_eval_step = timed_eval_step
    try:
        with _recording(qa, calls):
            yield
    finally:
        train_lib.TrainModule.train_epoch = train_epoch
        eval_lib.make_eval_step = make_eval_step


def finetune_path(tmp, walks, phase8_ms, smi):
    """Phase 20: ``tpat_tpu_torch.cli.finetune.main`` with ft_esc50.sh's
    flags on the card, from WAVs on disk to the kept best model: each
    epoch's phase, each step's launches and geometry against phase 8's
    walk of the same step kind, 12 forward launches per eval forward, the
    artifacts, and an ``--eval`` of best_model that gives the logged best
    acc1.  ``phase8_ms`` (phase 8's ms per step by walk, this run) is
    logged beside the finetune steps.  Returns the run's launches (fwd,
    prefix fwd, bwd rows, bwd cols), the corpus' paths and the loader
    summary that phase 22 prints beside its own (``_loader_summary``)."""
    import numpy as np

    from tpat_tpu_torch.cli import finetune
    from tpat_tpu_torch.config import audiomae_vit_base
    from tpat_tpu_torch.ops import qkv_attention as qa

    t_corpus = time.perf_counter()
    paths = finetune_corpus(os.path.join(tmp, "esc50"), audiomae_vit_base(
        target_length=1024, num_classes=527))
    log(f"finetune corpus: {FINETUNE_CLIPS} clips of {FINETUNE_SECONDS} s "
        f"written in {time.perf_counter() - t_corpus:.1f} s")
    out = os.path.join(tmp, "ft_out")
    argv = finetune_argv(paths, out)
    # an eval forward is the static forward: the static step's forward
    # launches
    per_forward = (_walk_counts(walks[EPOCH_LABELS[4]])[0], 0, 0, 0)
    calls, epochs, evals = [], [], []
    with _finetune_recording(qa, calls, epochs, evals):
        qa.launches = qa.prefix_launches = 0  # the main path starts here
        qa.bwd_rows_launches = qa.bwd_cols_launches = 0
        _gelu_zero()
        t0 = time.perf_counter()
        best = finetune.main(finetune.get_args_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _counts(qa)  # the main path ends here
        _gelu_read("finetune")

    with open(os.path.join(out, "log.txt")) as f:
        logs = [json.loads(line) for line in f]
    phases = [e["train_phase"] for e in logs]
    if phases != FINETUNE_PHASES:
        raise AssertionError(f"finetune phases {phases}")
    for e in logs:
        if not all(math.isfinite(e[k]) for k in ("train_loss", "test_loss")):
            raise AssertionError(f"finetune epoch {e['epoch']}: {e}")
    markers = [p for p in os.listdir(out) if p.startswith("best-")]
    want = f"best-{best['best_epoch']:03d}-{best['best_score']:.4f}.txt"
    if markers != [want]:
        raise AssertionError(f"best markers {markers}, expected [{want}]")
    for name in ("best_model", "train_result.txt", "args.yaml"):
        if not os.path.isfile(os.path.join(out, name)):
            raise AssertionError(f"finetune wrote no {name}")
    if [r["epoch"] for r in epochs] != list(range(len(FINETUNE_PHASES))):
        raise AssertionError(f"train epochs recorded {[r['epoch'] for r in epochs]}")
    summed = [0, 0, 0, 0]
    for rec, label in zip(epochs, FINETUNE_WALKS):
        walk = tuple(walks[label])
        if len(rec["steps"]) != FINETUNE_CLIPS[0] // FINETUNE_BATCH:
            raise AssertionError(f"epoch {rec['epoch']}: {len(rec['steps'])} steps")
        for ms, got, step_calls in rec["steps"]:
            if step_calls != walk or got != _walk_counts(walk):
                raise AssertionError(
                    f"finetune epoch {rec['epoch']}: launches {got} at "
                    f"{len(step_calls)} recorded calls; phase 8's '{label}' "
                    f"step launched {_walk_counts(walk)} at {len(walk)}")
            summed = [a + b for a, b in zip(summed, got)]
    n_eval = -(-FINETUNE_CLIPS[1] // FINETUNE_BATCH) * len(FINETUNE_PHASES)
    if len(evals) != n_eval:
        raise AssertionError(f"{len(evals)} eval forwards, expected {n_eval}")
    for ms, got, rows in evals:
        if got != per_forward or rows != FINETUNE_BATCH:
            raise AssertionError(f"eval forward of {rows} rows launched {got}")
        summed[0] += got[0]
    if tuple(summed) != launches:
        raise AssertionError(f"finetune launches {launches}, steps and eval "
                             f"forwards account for {tuple(summed)}")

    for rec, e in zip(epochs, logs):
        label = FINETUNE_WALKS[rec["epoch"]]
        step_ms = [round(s[0], 1) for s in rec["steps"]]
        wait = sum(rec["wait_ms"])
        same = (f"{phase8_ms[label]:.1f}" if label in phase8_ms
                else "not timed")
        log(f"finetune epoch {rec['epoch']} ({e['train_phase']}, "
            f"{label}): ms per step {step_ms} (phase 8: {same}); loader "
            f"wait {[round(w, 1) for w in rec['wait_ms']]} ms, "
            f"{wait / rec['wall_ms']:.3f} of the epoch's {rec['wall_ms']:.0f} "
            f"ms; train_loss {e['train_loss']:.4f} test_acc1 "
            f"{e['test_acc1']:.2f} test_loss {e['test_loss']:.4f} ({smi})")
    eval_ms = [ms for ms, _, _ in evals]
    log(f"finetune eval forwards (b{FINETUNE_BATCH}, {per_forward[0]} B1 "
        f"launches each): "
        f"{np.median(eval_ms):.2f} ms median of {len(eval_ms)}, "
        f"{sum(eval_ms) / (FINETUNE_CLIPS[1] * len(FINETUNE_PHASES)):.3f} ms "
        f"per eval clip ({smi})")
    log(f"finetune run: {wall_s:.1f} s wall; launches (fwd, prefix fwd, bwd "
        f"rows, bwd cols) {launches}; best acc1 {best['best_score']:.4f} at "
        f"epoch {best['best_epoch']}")

    c0 = _counts(qa)
    stats = finetune.main(finetune.get_args_parser().parse_args(
        argv + ["--eval", "--finetuned_model_path",
                os.path.join(out, "best_model"),
                "--result_path", os.path.join(out, "eval_result.txt")]))
    eval_launches = tuple(a - b for a, b in zip(_counts(qa), c0))
    logged = logs[best["best_epoch"]]
    if stats["acc1"] != logged["test_acc1"]:
        raise AssertionError(f"--eval of best_model: acc1 {stats['acc1']}, "
                             f"logged {logged['test_acc1']}")
    log(f"finetune --eval of best_model: acc1 {stats['acc1']:.4f} (logged "
        f"{logged['test_acc1']:.4f}), loss {stats['loss']:.6f} (logged "
        f"{logged['test_loss']:.6f}), launches {eval_launches}")
    summary = dict(_loader_summary(epochs), eval_ms=float(np.median(eval_ms)),
                   epoch_ms=[rec["wall_ms"] for rec in epochs])
    del calls, epochs
    torch.cuda.empty_cache()
    return launches, paths, summary


def _loader_summary(epochs) -> dict:
    """The loader wait per batch (ms, mean over the run), its share of the
    training epochs' wall time, and the first and second step's ms of each
    epoch, from ``_finetune_recording``'s records."""
    waits = [w for rec in epochs for w in rec["wait_ms"]]
    return {
        "wait_ms": sum(waits) / len(waits),
        "wait_share": sum(waits) / sum(rec["wall_ms"] for rec in epochs),
        "step_ms": [[round(s[0], 1) for s in rec["steps"][:2]] for rec in epochs],
    }


# Phase 21: scripts/ast_run_esc.sh through the port's run_ast, on phase 20's
# corpus, from a seeded AST "AudioSet-pretrained" .pth
AST_BATCH = 48  # ast_run_esc.sh's batch_size: 5 steps of 256 clips, 5 evals
# ast_run_esc.sh's 30 epochs (shrink from 5 over 10) cut to four, counted
# from 1: dense, anneal at the cosine's t = 0 (the dense step), anneal at
# rates 0.85 (the hybrid step at bucket 0.9), static
AST_FLAGS = ("--n-epochs", "4", "--shrink_start_epoch", "2",
             "--shrink_epochs", "2")
AST_PHASES = ("dense", "dense", "hybrid", "static")  # the step of each epoch
AST_AUDIOSET = (1024, 64)  # ast_run_audioset.sh's frames and batch
AST_WIDTHS = [258, 182, 128, 91]  # ESC-50 (512 frames) at keep 0.7
AST_BAND = ("--drop_token_blk_idx", "3", "--retain_min", "-0.6170",
            "--retain_max", "1.0952")  # an SPC-2 cluster, ast_run_sc.sh:15-17


def ast_pretrained_pth(path, seed):
    """A seeded AST 'AudioSet-pretrained' .pth in the reference layout
    (``module.v.*``, ``module.mlp_head.{0,1}.*``) from the port's own
    ViT-B AST at the AudioSet grid: 514 pos rows, a 527-class head."""
    from tpat_tpu_torch.config import ast_vit_base
    from tpat_tpu_torch.models.vit import AudioViT

    sd = sharpened_state_dict(
        AudioViT(ast_vit_base(target_length=1024, num_classes=527)), seed)
    torch.save({("module." if k.startswith("mlp_head.") else "module.v.") + k: v
                for k, v in sd.items()}, path)


def ast_argv(paths, pth, out):
    """ast_run_esc.sh's flags for one fold, with AST_FLAGS' epoch counts."""
    return [
        "--dataset", "esc50", "--n_class", str(FINETUNE_CLASSES),
        "--audio_length", "512", "--data-train", paths["train"],
        "--data-val", paths["eval"], "--label-csv", paths["labels"],
        "--lr", "1e-5", "-b", str(AST_BATCH), "--freqm", "24", "--timem", "96",
        "--mixup", "0", "--dataset_mean", "-6.6268077",
        "--dataset_std", "5.358466", "--metrics", "acc", "--loss", "CE",
        "--warmup", "False", "--lrscheduler_start", "5",
        "--lrscheduler_step", "1", "--lrscheduler_decay", "0.85",
        "--base_keep_rate", "0.7", "--drop_loc", "(3, 6, 9)",
        "--imagenet_pretrain", "True", "--audioset_pretrain", "True",
        "--audioset_pretrained_model_path", pth, "--exp-dir", out, *AST_FLAGS,
    ]


def ast_walk(cfg, batch, rates, *, bucket=None, num_left=None, rank=False,
             unmasked_until=None, train=False):
    """The launches one AST step or eval forward must make, as ``_recording``
    records them, from the configuration alone: a multiset (Counter) of
    (kind, B, N, 3C, bf16, H, mode, 2, kv_valid, False).  Static widths
    (the drop blocks emit 'cls' scores); ``rank``: the custom-rank
    forward's take_rows widths, no scores; ``bucket``: the hybrid step's
    bucket widths, the prefix form after the first drop block at kv_valid
    = 2 + the last drop block's ``num_left``; ``unmasked_until``: the band
    forward, whose blocks past it attend through the masked plain path.
    ``train`` adds one backward per forward, without a score cotangent."""
    import collections

    from tpat_tpu_torch.config import compose_kept_counts
    from tpat_tpu_torch.ops import pruning

    e = cfg.num_extra_tokens
    fwd = []
    n, prefix = e + cfg.num_patches, None
    first = min(cfg.drop_loc)
    counts = compose_kept_counts(bucket, cfg.num_patches) if bucket else None
    for i in range(cfg.depth):
        if unmasked_until is not None and i > unmasked_until:
            break
        drop = rates[i] < 1.0
        kv = None if bucket is None or i <= first else e + prefix
        mode = "cls" if drop and not rank else None
        fwd.append(("fwd", batch, n, 3 * cfg.embed_dim, torch.bfloat16,
                    cfg.num_heads, mode, e, kv, False))
        if drop and bucket is not None:
            n, prefix = e + counts[i], num_left[i]
        elif drop:
            k = pruning.num_left_tokens(rates[i], n - e)
            n = k if rank else e + k
    bwd = [("bwd",) + c[1:] for c in fwd] if train else []
    return collections.Counter(fwd + bwd)


def ast_path(tmp, paths, smi):
    """Phase 21: ``tpat_tpu_torch.cli.run_ast.main`` with ast_run_esc.sh's
    flags on the card, from WAVs on disk to ``models/best_audio_model``:
    each epoch's steps and each eval forward against their expected
    launches (``ast_walk``), every launch of the run accounted for, the
    artifacts, ``--eval`` of the kept model (the logged best score), with
    ``--custom_rank mean`` (no scores anywhere) and with the intensity band;
    then one static forward at ast_run_audioset.sh's geometry, 'fused' vs
    'xla' in f32.  Returns (the run's launches, {walk: one step's or
    forward's recorded launches})."""
    import collections

    import numpy as np

    from tpat_tpu_torch.cli import run_ast
    from tpat_tpu_torch.config import ast_vit_base
    from tpat_tpu_torch.engine import schedules
    from tpat_tpu_torch.ops import qkv_attention as qa

    pth = os.path.join(tmp, "ast_audioset.pth")
    ast_pretrained_pth(pth, FINETUNE_SEED)
    out = os.path.join(tmp, "ast_out")
    argv = ast_argv(paths, pth, out)
    _, cfg = run_ast.configs(run_ast.get_parser().parse_args(argv))
    steps_per_epoch = FINETUNE_CLIPS[0] // AST_BATCH
    evals_per_run = -(-FINETUNE_CLIPS[1] // AST_BATCH)
    rates = schedules.scheduled_keep_rates(
        3 * steps_per_epoch, 3, shrink_start_epoch=2, total_epochs=4,
        iters_per_epoch=steps_per_epoch, base_keep_rate=0.7,
        num_blocks=cfg.depth, drop_loc=cfg.drop_loc)
    bucket = schedules.bucket_keep_rates(rates, base_keep_rate=0.7, n_buckets=4)
    num_left = schedules.masked_kept_counts(rates, cfg.drop_loc, cfg.num_patches)
    d0 = cfg.drop_loc[0]
    if not (abs(rates[d0] - 0.85) < 1e-9 and abs(bucket[d0] - 0.9) < 1e-9):
        raise AssertionError(f"epoch 3's rates {rates}, bucket {bucket}")
    ones = (1.0,) * cfg.depth
    want = {
        "dense": ast_walk(cfg, AST_BATCH, ones, train=True),
        "hybrid": ast_walk(cfg, AST_BATCH, rates, bucket=bucket,
                           num_left=num_left, train=True),
        "static": ast_walk(cfg, AST_BATCH, cfg.keep_rates, train=True),
        "eval": ast_walk(cfg, AST_BATCH, cfg.keep_rates),
    }
    walk_n = sorted({c[2] for c in want["static"]}, reverse=True)
    if walk_n != AST_WIDTHS:
        raise AssertionError(f"AST ESC-50 static widths {walk_n}")

    calls, epochs, evals = [], [], []
    with _finetune_recording(qa, calls, epochs, evals):
        qa.launches = qa.prefix_launches = 0  # the main path starts here
        qa.bwd_rows_launches = qa.bwd_cols_launches = 0
        _gelu_zero()
        t0 = time.perf_counter()
        best = run_ast.main(run_ast.get_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = _counts(qa)  # the main path ends here
        _gelu_read("ast")

    result = np.loadtxt(os.path.join(out, "result.csv"), delimiter=",")
    if result.shape != (4, 4) or not np.isfinite(result).all():
        raise AssertionError(f"result.csv {result}")
    if list(result[:, 0]) != [1, 2, 3, 4]:
        raise AssertionError(f"result.csv epochs {result[:, 0]}")
    for name in ("best_result.csv", "progress.pkl", "args.yaml",
                 os.path.join("models", "best_audio_model")):
        if not os.path.isfile(os.path.join(out, name)):
            raise AssertionError(f"run_ast wrote no {name}")
    best_epoch, best_score = np.loadtxt(os.path.join(out, "best_result.csv"),
                                        delimiter=",")
    if best_score != best or result[int(best_epoch) - 1, 1] != best:
        raise AssertionError(f"best {best} vs best_result.csv "
                             f"{(best_epoch, best_score)} and result.csv")
    if [r["epoch"] for r in epochs] != [1, 2, 3, 4]:
        raise AssertionError(f"epochs recorded {[r['epoch'] for r in epochs]}")
    walks, summed = {}, collections.Counter()
    for rec, kind in zip(epochs, AST_PHASES):
        if len(rec["steps"]) != steps_per_epoch:
            raise AssertionError(f"AST epoch {rec['epoch']}: "
                                 f"{len(rec['steps'])} steps")
        for ms, got, step_calls in rec["steps"]:
            if collections.Counter(step_calls) != want[kind]:
                raise AssertionError(
                    f"AST epoch {rec['epoch']} ({kind} step): launches "
                    f"{sorted(collections.Counter(step_calls).items(), key=str)}"
                    f", expected {sorted(want[kind].items(), key=str)}")
            if got != _walk_counts(step_calls):
                raise AssertionError(f"AST epoch {rec['epoch']}: counters "
                                     f"{got}, recorded {_walk_counts(step_calls)}")
            walks.setdefault(f"AST b{AST_BATCH} {kind} train step", step_calls)
            summed.update(step_calls)
    if len(evals) != evals_per_run * 4:
        raise AssertionError(f"{len(evals)} AST eval forwards")
    for ms, got, rows in evals:
        if rows != AST_BATCH or got != (cfg.depth, 0, 0, 0):
            raise AssertionError(f"AST eval forward of {rows} rows: {got}")
    train_calls = sum((list(s[2]) for r in epochs for s in r["steps"]), [])
    eval_only = collections.Counter(calls) - collections.Counter(train_calls)
    if eval_only != collections.Counter({k: v * len(evals)
                                         for k, v in want["eval"].items()}):
        raise AssertionError("AST eval forwards: launches differ from "
                             "the static forward's")
    walks[f"AST b{AST_BATCH} eval forward"] = tuple(want["eval"].elements())
    summed.update(eval_only)
    if _walk_counts(list(summed.elements())) != launches or _walk_counts(calls) != launches:
        raise AssertionError(f"AST launches {launches}, steps and eval "
                             f"forwards account for "
                             f"{_walk_counts(list(summed.elements()))}")
    for rec, kind in zip(epochs, AST_PHASES):
        wait = sum(rec["wait_ms"])
        log(f"AST epoch {rec['epoch']} ({kind} step): ms per step "
            f"{[round(s[0], 1) for s in rec['steps']]}; loader wait "
            f"{[round(w, 1) for w in rec['wait_ms']]} ms, "
            f"{wait / rec['wall_ms']:.3f} of the epoch's "
            f"{rec['wall_ms']:.0f} ms; score "
            f"{result[rec['epoch'] - 1, 1]:.4f} train loss "
            f"{result[rec['epoch'] - 1, 2]:.4f} ({smi})")
    eval_ms = [ms for ms, _, _ in evals]
    log(f"AST eval forwards (b{AST_BATCH}, {cfg.depth} B1 launches each): "
        f"{np.median(eval_ms):.2f} ms median of {len(eval_ms)}, "
        f"{sum(eval_ms) / (FINETUNE_CLIPS[1] * 4):.3f} card ms per eval clip "
        f"({smi})")
    log(f"AST run: {wall_s:.1f} s wall; launches (fwd, prefix fwd, bwd rows, "
        f"bwd cols) {launches}; best acc {best:.4f} at epoch {int(best_epoch)}")

    def evaluate(extra, what, want_walk):
        ev, got = [], []
        with _finetune_recording(qa, got, [], ev):
            score = run_ast.main(run_ast.get_parser().parse_args(
                argv + ["--eval", *extra]))
        if not math.isfinite(score) or len(ev) != evals_per_run:
            raise AssertionError(f"--eval {what}: score {score}, {len(ev)} "
                                 "forwards")
        per = collections.Counter({k: v * evals_per_run
                                   for k, v in want_walk.items()})
        if collections.Counter(got) != per:
            raise AssertionError(f"--eval {what}: launches "
                                 f"{sorted(collections.Counter(got).items(), key=str)}")
        saved = np.loadtxt(os.path.join(out, "eval_result.csv"))
        if list(saved) != [-1.0, score]:
            raise AssertionError(f"--eval {what}: eval_result.csv {saved}")
        log(f"AST --eval {what}: acc {score:.4f}, "
            f"{sum(want_walk.values())} launches per forward")
        walks[f"AST b{AST_BATCH} eval forward, {what}"] = tuple(
            got[:sum(want_walk.values())])
        return score

    if evaluate([], "best_audio_model", want["eval"]) != best:
        raise AssertionError("--eval of best_audio_model differs from the "
                             "logged best")
    evaluate(["--custom_rank", "mean"], "custom_rank mean",
             ast_walk(cfg, AST_BATCH, cfg.keep_rates, rank=True))
    band_blk = int(AST_BAND[1])
    evaluate(list(AST_BAND), f"intensity band after block {band_blk}",
             ast_walk(cfg, AST_BATCH, cfg.keep_rates,
                      unmasked_until=min(band_blk, *cfg.drop_loc)))
    walks.update(ast_audioset_forward())
    torch.cuda.empty_cache()
    return launches, walks


def ast_audioset_forward() -> dict:
    """One static forward at ast_run_audioset.sh's geometry (1024 frames,
    N = 514, b64, keep 0.7 at (3, 6, 9)) from sharpened weights: 'fused'
    vs 'xla' in f32 (logits within the model-level tolerance, the same
    kept tokens at each drop block, composed to patch ids as phase 10
    does), and the bf16 forward's launches recorded (514 -> 361 -> 254 ->
    179).  Returns {walk: its launches}."""
    from tpat_tpu_torch.config import ast_vit_base
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops import qkv_attention as qa

    frames, b = AST_AUDIOSET
    cfg = ast_vit_base(target_length=frames, num_classes=527,
                       base_keep_rate=0.7, drop_loc=(3, 6, 9))
    sd = sharpened_state_dict(AudioViT(cfg), SEED + 7)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x = torch.randn(b, 1, 128, frames, device="cuda", generator=gen)

    def run(dtype, impl, calls=None):
        m = AudioViT(dataclasses.replace(cfg, compute_dtype=dtype,
                                         attention_impl=impl), device="cuda")
        m.load_state_dict(sd, strict=True)
        m.eval()
        with torch.no_grad(), _recording(qa, calls if calls is not None else []):
            return m(x, extract_features=True)

    lf, ff = run("float32", "fused")
    lx, fx = run("float32", "xla")
    # the kept tokens, not their order: the CLS-row scores of 512 patches
    # hold exact f32 ties and gaps of 1e-7 relative, below the kernel's
    # ~4e-6 difference from plain, so tied tokens may rank either way
    picked = [[f[f"block-{i}.topk_idx"] for i in cfg.drop_loc] for f in (ff, fx)]
    reordered = _same_kept_tokens("AST N=514 f32 fused vs xla", *picked,
                                  [None] * 3, cfg.num_patches)
    torch.testing.assert_close(lf, lx, rtol=F32_LOGIT_RTOL, atol=F32_LOGIT_ATOL)
    calls = []
    lb, _ = run("bfloat16", "fused", calls)
    widths = sorted({c[2] for c in calls}, reverse=True)
    if widths != [514, 361, 254, 179] or len(calls) != 12 \
            or not torch.isfinite(lb).all():
        raise AssertionError(f"AST N=514 bf16 forward: widths {widths}, "
                             f"{len(calls)} launches")
    log(f"AST AudioSet geometry (b{b}, N 514 -> 361 -> 254 -> 179): f32 fused "
        f"vs xla keep the same tokens at blocks 3/6/9 (rows ranked in another "
        f"order: {reordered}), logits max abs diff "
        f"{(lf - lx).abs().max().item():.3g}; bf16 forward finite")
    return {f"AST b{b} AudioSet-geometry eval forward": tuple(calls)}


def _entry(name, source, replaces, launches, err, ms, plain, bound, lib,
           per, **extra):
    """One kernel's record in the kernels line; ``replaces`` is the TPU
    kernel's repo-relative file:line."""
    bms, by = bound
    return {"name": name, "route": "cuda",
            "source": "tpat_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib, "per": per,
            **extra}


# ---------------------------------------------------------------------------
# Phase 22: the waveform path (the device frontend on the card, training,
# serving) and decoding patch importance (feature extraction, extract_stats),
# then remat and dropout, on phase 20's corpus
# ---------------------------------------------------------------------------

# device frontend vs the host path, per clip: tests/test_frontend.py:34, :57
FRONTEND_RTOL, FRONTEND_ATOL = 1e-3, 2e-3
FRONTEND_SHORT = 3 * 16000  # the clip cut to 3 s: a NaN tail
FRONTEND_HEAD = (37, 2 * 16000)  # a 2-s clip after 37 frames of NaN head
# the walks of the --device_frontend run's epochs: dense, the hybrid step at
# the cosine's t = 0 (a preprocess keeps it off the dense step; its kv_valid
# is then N: phase 8's bucket-1.0 walk with every prefix at full width),
# the hybrid step at bucket 0.9, static
WAVE_WALKS = (EPOCH_LABELS[0], "t0", BUCKET_09, EPOCH_LABELS[4])
WAVE_SPECAUG = [True, True, False, False, False, False, False, False]
FEATURE_WIDTHS = {3: 180, 6: 126, 9: 89}  # ceil(0.7 N) at the drop blocks
WAVE_BUCKETS = (1, 8)
WAVE_REQUEST = 9  # clips: bucket 8, then bucket 1


def _t0_walk(walk) -> tuple:
    """A hybrid walk with every prefix launch at kv_valid = N (rates 1.0)."""
    return tuple(c if c[8] is None else c[:8] + (c[2],) + c[9:] for c in walk)


def _kept_sets_up_to_ties(picked_f, picked_x, scores_x, num_patches):
    """Phase 10's rule (``_same_kept_tokens``: the kept sets, composed into
    original patch ids, equal at every drop block) on a trained model's
    f32 forward, whose scores can tie: a row whose sets differ passes only
    where 'xla''s k-th and (k+1)-th scores at that block lie within the
    kernel's score tolerance (SCORE_RTOL, SCORE_ATOL) of each other, so
    either token may rank first; the row is then left out of the later
    blocks, whose inputs differ.  Returns the tied swaps as (block index,
    row, gap)."""
    ids_f = ids_x = None
    live = None
    ties = []
    for j, (jf, jx, sx) in enumerate(zip(picked_f, picked_x, scores_x)):
        if ids_f is None:
            ids_f = ids_x = torch.arange(num_patches, device=jf.device).expand(
                jf.shape[0], -1)
            live = torch.ones(jf.shape[0], dtype=torch.bool, device=jf.device)
        ids_f, ids_x = ids_f.gather(1, jf), ids_x.gather(1, jx)
        differ = (ids_f.sort(dim=1).values != ids_x.sort(dim=1).values).any(1)
        k = jx.shape[1]
        for row in (differ & live).nonzero().flatten().tolist():
            top = sx[row].sort(descending=True).values
            gap = (top[k - 1] - top[k]).item()
            if not gap <= SCORE_RTOL * abs(top[k - 1].item()) + SCORE_ATOL:
                raise AssertionError(
                    f"drop block {j}: row {row} keeps other tokens with a "
                    f"score gap of {gap:.3g} at the k-th token")
            ties.append((j, row, gap))
        live &= ~differ
    return ties


def frontend_on_card(paths, ft_loader, smi):
    """Phase 22.1: ``device_frontend`` on a b128 batch of phase 20's 5-s
    clips (one cut to 3 s with a NaN tail, one 2-s clip after a VoxCeleb
    NaN head of 37 frames) against the host path (``fbank_numpy`` ->
    ``pad_or_crop`` -> ``normalize``) per clip, then its ms per batch
    (CUDA events).  Returns the waveform batch (numpy) and the frontend
    config."""
    import numpy as np

    from tpat_tpu_torch.config import DATASET_PRESETS
    from tpat_tpu_torch.data.datasets import AudiosetDataset
    from tpat_tpu_torch.ops import fbank as fb
    from tpat_tpu_torch.ops.frontend import FrontendConfig, device_frontend

    data_cfg = dataclasses.replace(DATASET_PRESETS["esc50"],
                                   num_classes=FINETUNE_CLASSES)
    ds = AudiosetDataset(paths["eval"], data_cfg, paths["labels"], train=False,
                         return_waveform=True)
    wav = np.stack([ds[i][0] for i in range(FINETUNE_BATCH)])
    wav[1, FRONTEND_SHORT:] = np.nan
    frames, length = FRONTEND_HEAD
    clip = wav[2, :length].copy()
    wav[2] = np.nan
    wav[2, frames * 160:frames * 160 + length] = clip
    cfg = FrontendConfig(num_mel_bins=128, target_length=data_cfg.target_length,
                         norm_mean=data_cfg.norm_mean, norm_std=data_cfg.norm_std)
    x = torch.from_numpy(wav).cuda()
    got = device_frontend(x, cfg).cpu()
    if got.shape != (FINETUNE_BATCH, 1, cfg.target_length, 128):
        raise AssertionError(f"frontend shape {tuple(got.shape)}")
    worst = 0.0
    for i in range(FINETUNE_BATCH):
        real = clip if i == 2 else wav[i][np.isfinite(wav[i])]
        mel = fb.pad_or_crop(fb.fbank_numpy(real), cfg.target_length,
                             pad_left=frames if i == 2 else 0)
        want = torch.from_numpy(fb.normalize(mel, cfg.norm_mean, cfg.norm_std))
        worst = max(worst, _close(got[i, 0], want, FRONTEND_ATOL, FRONTEND_RTOL))
    ms = _time_ms(lambda: device_frontend(x, cfg))
    log(f"device frontend b{FINETUNE_BATCH} (5-s clips, 82160 samples, one "
        f"NaN tail, one NaN head of {frames} frames): equals the host path "
        f"within rtol {FRONTEND_RTOL} / atol {FRONTEND_ATOL} (worst |err| "
        f"{worst:.3g}); {ms:.3f} ms per batch on the card, beside phase 20's "
        f"loader wait of {ft_loader['wait_ms']:.1f} ms per batch ({smi})")
    return wav, cfg


def waveform_training(tmp, paths, walks, ft_loader, smi):
    """Phase 22.2: ``cli.finetune.main`` with ft_esc50.sh's flags and
    ``--device_frontend true``: the epochs' phases, each step's launches
    and geometry against phase 8's walks (``WAVE_WALKS``), 12 B1 launches
    per eval forward, SpecAug only in the dense epoch, the loader wait and
    the step ms beside phase 20's.  Returns (launches, argv, out dir)."""
    import numpy as np

    from tpat_tpu_torch.cli import finetune
    from tpat_tpu_torch.ops import qkv_attention as qa

    out = os.path.join(tmp, "wave_out")
    argv = finetune_argv(paths, out) + ["--device_frontend", "true"]
    expected = {label: tuple(walks[label]) for label in WAVE_WALKS if label != "t0"}
    expected["t0"] = _t0_walk(walks[EPOCH_LABELS[2]])
    per_forward = (_walk_counts(walks[EPOCH_LABELS[4]])[0], 0, 0, 0)
    flags = []  # the specaug argument of each train step's preprocess
    make_preprocess = finetune.make_preprocess

    def recording(data_cfg, **kw):
        pre = make_preprocess(data_cfg, **kw)

        def wrapped(x, generator, specaug, train):
            if train:
                flags.append(specaug)
            return pre(x, generator, specaug, train)
        return wrapped

    finetune.make_preprocess = recording
    calls, epochs, evals = [], [], []
    try:
        with _finetune_recording(qa, calls, epochs, evals):
            qa.launches = qa.prefix_launches = 0  # the main path starts here
            qa.bwd_rows_launches = qa.bwd_cols_launches = 0
            _gelu_zero()
            t0 = time.perf_counter()
            finetune.main(finetune.get_args_parser().parse_args(argv))
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = _counts(qa)  # the main path ends here
            _gelu_read("waveform")
    finally:
        finetune.make_preprocess = make_preprocess
    with open(os.path.join(out, "log.txt")) as f:
        logs = [json.loads(line) for line in f]
    if [e["train_phase"] for e in logs] != FINETUNE_PHASES:
        raise AssertionError(f"waveform run phases {[e['train_phase'] for e in logs]}")
    if not all(math.isfinite(e[k]) for e in logs for k in ("train_loss", "test_loss")):
        raise AssertionError(f"waveform run log {logs}")
    if flags != WAVE_SPECAUG:
        raise AssertionError(f"SpecAug per step {flags}, expected {WAVE_SPECAUG}")
    summed = [0, 0, 0, 0]
    for rec, label in zip(epochs, WAVE_WALKS):
        want = expected[label]
        for _ms, got, step_calls in rec["steps"]:
            if step_calls != want or got != _walk_counts(want):
                raise AssertionError(
                    f"waveform epoch {rec['epoch']}: launches {got} at "
                    f"{len(step_calls)} recorded calls; expected "
                    f"{_walk_counts(want)} at {len(want)} ({label})")
            summed = [a + b for a, b in zip(summed, got)]
    for _ms, got, rows in evals:
        if got != per_forward:
            raise AssertionError(f"waveform eval forward of {rows} rows launched {got}")
        summed[0] += got[0]
    if tuple(summed) != launches:
        raise AssertionError(f"waveform launches {launches}, steps and eval "
                             f"forwards account for {tuple(summed)}")
    mine = _loader_summary(epochs)
    eval_ms = float(np.median([ms for ms, _, _ in evals]))
    log(f"waveform finetune run (--device_frontend true): phases "
        f"{FINETUNE_PHASES}, SpecAug per step {flags}, every step's launches "
        f"and geometry as phase 8's walk ({', '.join(WAVE_WALKS)}), launches "
        f"{launches}; {wall_s:.1f} s wall; loader wait {mine['wait_ms']:.1f} "
        f"ms per batch, {mine['wait_share']:.3f} of the epochs (phase 20: "
        f"{ft_loader['wait_ms']:.1f} ms, {ft_loader['wait_share']:.3f}); "
        f"first and second step ms per epoch {mine['step_ms']} (phase 20: "
        f"{ft_loader['step_ms']}); eval forwards (the frontend included) "
        f"{eval_ms:.2f} ms median of {len(evals)} "
        f"(phase 20: {ft_loader['eval_ms']:.2f}); test_acc1 per epoch "
        f"{[round(e['test_acc1'], 2) for e in logs]} ({smi})")
    del calls, epochs
    torch.cuda.empty_cache()
    return launches, argv, out


def feature_extraction(tmp, argv, out, smi):
    """Phase 22.3: ``--eval --flag_extract_features true`` of the waveform
    run's best_model: the file set, the drop blocks' widths, an attn_score
    per block; the kept sets of a batch's f32 forward through the kernels
    equal to 'xla''s up to tied scores (``_kept_sets_up_to_ties``); then
    the port's extract_stats
    (Kendall tau per block for both stats, the retained count).  Returns
    the eval's launches."""
    import numpy as np

    from tpat_tpu_torch.analysis import extract_stats
    from tpat_tpu_torch.cli import finetune
    from tpat_tpu_torch.config import audiomae_vit_base
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.utils import checkpoint as ckpt_lib

    feats = os.path.join(tmp, "wave_features")
    best = os.path.join(out, "best_model")
    c0 = _counts(qa)
    stats = finetune.main(finetune.get_args_parser().parse_args(argv + [
        "--eval", "--finetuned_model_path", best, "--flag_extract_features",
        "true", "--extract_features_path", feats,
        "--result_path", os.path.join(out, "extract_result.txt")]))
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(_counts(qa), c0))
    batches = -(-FINETUNE_CLIPS[1] // FINETUNE_BATCH)
    keys = {"mel", "labels", *(f"block-{i}.attn_score" for i in range(12)),
            *(f"block-{i}.topk_idx" for i in FEATURE_WIDTHS)}
    want = sorted(f"{k}.{i:04d}.pth" for k in keys for i in range(batches))
    if sorted(os.listdir(feats)) != want:
        raise AssertionError(f"feature files {sorted(os.listdir(feats))}")
    for blk, width in FEATURE_WIDTHS.items():
        idx = torch.load(os.path.join(feats, f"block-{blk}.topk_idx.0000.pth"))
        if tuple(idx.shape) != (FINETUNE_BATCH, width):
            raise AssertionError(f"block {blk} topk_idx {tuple(idx.shape)}")
    mel = torch.load(os.path.join(feats, "mel.0000.pth"))
    if tuple(mel.shape) != (FINETUNE_BATCH, 1, 512, 128):
        raise AssertionError(f"mel feature {tuple(mel.shape)}")

    sd = ckpt_lib.restore_checkpoint(best)["model"]
    picked, scores = {}, {}
    for impl in ("fused", "xla"):
        cfg = audiomae_vit_base(target_length=512, num_classes=FINETUNE_CLASSES,
                                base_keep_rate=0.7, drop_loc=(3, 6, 9),
                                compute_dtype="float32", attention_impl=impl)
        model = AudioViT(cfg, device="cuda")
        model.load_state_dict(sd, strict=True)
        with torch.no_grad():
            _, f = model.eval()(mel.cuda(), extract_features=True)
        picked[impl] = [f[f"block-{b}.topk_idx"] for b in FEATURE_WIDTHS]
        scores[impl] = [f[f"block-{b}.attn_score"] for b in FEATURE_WIDTHS]
    ties = _kept_sets_up_to_ties(picked["fused"], picked["xla"], scores["xla"],
                                 cfg.num_patches)

    t0 = time.perf_counter()
    stats_dir = os.path.join(tmp, "wave_stats")
    for flag in ("--kendall_rank_mean", "--kendall_rank_std"):
        extract_stats.main(["--feature_dict_path", feats, "--output_dir",
                            stats_dir, flag, "--fig_title", "ESC-50"])
    taus = {}
    for stat in ("mean", "std"):
        with open(os.path.join(stats_dir, f"kendall_rank_{stat}.json")) as f:
            taus[stat] = json.load(f)["ESC-50"]
        if len(taus[stat]) != 12 or not all(map(math.isfinite, taus[stat])):
            raise AssertionError(f"Kendall tau ({stat}): {taus[stat]}")
    retained = extract_stats.retained_token_analyze(feats)
    stats_s = time.perf_counter() - t0
    log(f"feature extraction (--eval --flag_extract_features true, "
        f"{FINETUNE_CLIPS[1]} clips): {len(want)} files, topk widths "
        f"{list(FEATURE_WIDTHS.values())}, acc1 {stats['acc1']:.2f}, launches "
        f"{launches}; f32 kept sets equal to 'xla''s at blocks "
        f"{list(FEATURE_WIDTHS)} but for rows swapping tied tokens (block, "
        f"row, 'xla''s k-th minus (k+1)-th score): {ties}; "
        f"extract_stats in {stats_s:.1f} s: Kendall tau per block, mean "
        f"{[round(t, 4) for t in taus['mean']]}, std "
        f"{[round(t, 4) for t in taus['std']]}; retained low-intensity tokens "
        f"{retained} ({smi})")
    return launches


def waveform_serving(tmp, spec_dir, wav, fcfg):
    """Phase 22.4: ``export_serving --device_frontend`` of phase 4's .pth at
    buckets (1, 8); ``load_forward`` on 9 waveforms (bucket 8, then 1;
    the NaN-tail and NaN-head clips among them) against phase 4's
    spectrogram artifact on ``device_frontend``'s output, within phase 4's
    bf16 tolerance.  Returns its launches."""
    from tpat_tpu_torch.cli import export_serving
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.ops.frontend import device_frontend
    from tpat_tpu_torch.utils.serving import load_forward

    out_dir = os.path.join(tmp, "wave_artifact")
    export_serving.main(export_serving.get_parser().parse_args([
        "--model", "audiomae_vit_base", "--dataset", "esc50",
        "--nb_classes", "50", "--base_keep_rate", "0.7",
        "--drop_loc", "(3, 6, 9)", "--compute_dtype", "bfloat16",
        "--finetuned_model_path", os.path.join(tmp, "vit_b_esc50.pth"),
        "--batch_size", ",".join(map(str, WAVE_BUCKETS)), "--out_dir", out_dir,
        "--device_frontend"]))
    wfn, meta = load_forward(out_dir, device="cuda")
    if meta["frontend"]["input"] != "waveform" or meta["input_shape"] != [None, 82160]:
        raise AssertionError(f"waveform artifact meta {meta}")
    sfn, _ = load_forward(spec_dir, device="cuda")
    x = torch.from_numpy(wav[:WAVE_REQUEST]).cuda()
    c0 = _counts(qa)
    got = wfn(x)
    torch.cuda.synchronize()
    launches = tuple(a - b for a, b in zip(_counts(qa), c0))
    want = sfn(device_frontend(x, fcfg))
    err = (got - want).abs().max().item() / want.abs().max().item()
    if got.shape != (WAVE_REQUEST, 50) or not err <= BF16_LOGIT_REL:
        raise AssertionError(f"waveform serving: {tuple(got.shape)}, err / "
                             f"max|logit| {err:.3g} > {BF16_LOGIT_REL}")
    if launches != (24, 0, 0, 0):
        raise AssertionError(f"waveform serving launches {launches}")
    log(f"waveform serving (buckets {WAVE_BUCKETS}, {WAVE_REQUEST} clips): "
        f"logits vs the spectrogram artifact on device_frontend's output, err "
        f"/ max|logit| {err:.3g} (<= {BF16_LOGIT_REL}); launches {launches}")
    return launches


def remat_and_dropout(sd, smi):
    """Phase 22.5: one b128 bf16 dense train step (2D masking, drop-path
    0.1) with ``remat`` off and on, from the same weights, batch and
    generator: the loss within STEP_LOSS_RTOL, every gradient within GRAD_BF16_REL of its
    largest |entry|, and the peak memory of each; then a step at drop_rate
    0.1, whose loss must differ from drop_rate 0's."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine.train import TrainModule

    cfg, tc = _train_configs("bfloat16", 0.1)
    (x, y), = profile_train.synthetic_batches(cfg, FINETUNE_BATCH, 1, SEED + 6)

    def step(c):
        mod = TrainModule(c, tc, "ce", iters_per_epoch=2, device="cuda")
        state = mod.load(sd, seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, grads = mod.loss_and_grads(state, x, y, "dense",
                                         mask_prob=tc.mask_t_prob)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        names = [n for g in state.optimizer.param_groups for n in g["names"]]
        out = loss.item(), dict(zip(names, grads)), peak
        del state, mod
        torch.cuda.empty_cache()
        return out

    l0, g0, peak0 = step(cfg)
    l1, g1, peak1 = step(dataclasses.replace(cfg, remat=True))
    if not abs(l1 - l0) <= STEP_LOSS_RTOL * abs(l0):
        raise AssertionError(f"remat: loss {l1} vs {l0}")
    worst = 0.0
    for k, g in g0.items():
        scale = g.abs().max().item()
        err = (g1[k] - g).abs().max().item()
        if not err <= GRAD_BF16_REL * scale:
            raise AssertionError(f"remat: grad {k} err {err:.3g} > "
                                 f"{GRAD_BF16_REL} x {scale:.3g}")
        worst = max(worst, err / scale if scale else 0.0)
    ld, _, _ = step(dataclasses.replace(cfg, drop_rate=0.1))
    if not math.isfinite(ld) or ld == l0:
        raise AssertionError(f"dropout 0.1: loss {ld} (drop_rate 0: {l0})")
    log(f"remat, b{FINETUNE_BATCH} bf16 dense step: loss {l1:.6f}, {l0:.6f} "
        f"without; {len(g0)} gradients, worst err / max|grad| {worst:.3g}; "
        f"peak memory above the state {peak1 / 2**30:.2f} GiB with remat, "
        f"{peak0 / 2**30:.2f} GiB without; drop_rate 0.1: loss {ld:.6f} "
        f"({smi})")


def waveform_path(tmp, paths, walks, ft_loader, spec_dir, sd, smi):
    """Phase 22; returns its launches (fwd, prefix fwd, bwd rows, bwd cols):
    the waveform training run, the extraction eval and the waveform
    serving forwards."""
    t0 = time.perf_counter()
    wav, fcfg = frontend_on_card(paths, ft_loader, smi)
    train, argv, out = waveform_training(tmp, paths, walks, ft_loader, smi)
    extract = feature_extraction(tmp, argv, out, smi)
    serve = waveform_serving(tmp, spec_dir, wav, fcfg)
    remat_and_dropout(sd, smi)
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    return tuple(a + b + c for a, b, c in zip(train, extract, serve))


# ---------------------------------------------------------------------------
# Phase 23: scripts/run_pretrain.sh through the port's pretrain CLI, on a
# seeded AudioSet-shaped corpus; the plain decoder (decoder_mode 0) and B1/B3
# at head_dim 32; the pretrain -> finetune chain
# ---------------------------------------------------------------------------

PRETRAIN_CLIPS = 256  # one b256 step of run_pretrain.sh
PRETRAIN_SECONDS = 10.0  # AudioSet clips: 998 fbank frames, padded to 1024
AUDIOSET_CLASSES = 527
PRETRAIN_SEED = 23
PRETRAIN_CLI_BATCH = 32  # run_pretrain.sh's 256 cut to phase 13's batch
PRETRAIN_FULL_BATCH = 256  # run_pretrain.sh's batch
# run_pretrain.sh's flags (mae_vit_base_dec512d8b is --model mae_vit_base,
# the default); --batch_size and --epochs come from the runs below
PRETRAIN_FLAGS = ("--dataset", "audioset", "--blr", "2e-4", "--mask_2d",
                  "--mask_t_prob", "0.7", "--mask_f_prob", "0.3",
                  "--decoder_mode", "1", "--norm_pix_loss")
PRETRAIN_CUTS = (
    "batch 256 -> 32 (phase 13's batch) in runs 1-4 and 256 in run 5 (one "
    "step); epochs 32 -> 2, resumed to 3 from checkpoint-001; the .pth "
    "resume, decoder_mode 0 and the b256 step one epoch each; AS-20K's "
    "~20k clips -> 256 seeded tones of 10 s")
# tokens under --mask_2d 0.7/0.3 on the 64 x 8 AudioSet grid: kept time rows
# x kept frequency columns, plus CLS
PRETRAIN_ENC_N = 1 + int(64 * (1 - 0.7)) * int(8 * (1 - 0.3))
DEC0_N = 64 * 8 + 1  # the plain decoder over CLS and every patch
# per-step launches (B1, B3 rows, B3 cols, B5 fwd, B6 fwd, B5 bwd, B6 bwd, FMA)
PRETRAIN_CLI_LAUNCHES = {1: PRETRAIN_STEP_LAUNCHES["AudioSet"],
                         0: (28, 28, 28, 0, 0, 0, 0, 0)}


def pretrain_corpus(root):
    """Seeded 10-s WAVs in the AudioSet JSON layout (one to three of 527
    labels each, a tone per label with harmonics, a random gain and noise)
    and the 527-class label CSV."""
    import numpy as np

    from tpat_tpu_torch.data.wav import save_wav

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(PRETRAIN_SEED)
    sr = 16000
    t = np.arange(int(PRETRAIN_SECONDS * sr)) / sr
    entries = []
    for i in range(PRETRAIN_CLIPS):
        labels = rng.choice(AUDIOSET_CLASSES, size=int(rng.integers(1, 4)),
                            replace=False)
        w = sum(np.sin(2 * math.pi * (100.0 + 7.0 * c) * k * t
                       + rng.uniform(0, 6.3)) / k
                for c in labels for k in (1, 2))
        w = 0.1 * rng.uniform(0.5, 1.5) * w + 0.05 * rng.normal(size=t.size)
        path = os.path.join(root, f"as{i:03d}.wav")
        save_wav(path, w.astype(np.float32), sr)
        entries.append({"wav": path,
                        "labels": ",".join(f"/m/a{c:03d}" for c in labels)})
    paths = {"train": os.path.join(root, "as20k_16k.json"),
             "labels": os.path.join(root, "class_labels_indices.csv")}
    with open(paths["train"], "w") as f:
        json.dump({"data": entries}, f)
    with open(paths["labels"], "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(AUDIOSET_CLASSES):
            f.write(f'{c},/m/a{c:03d},"class {c}"\n')
    return paths


def pretrain_argv(paths, out, *extra):
    """run_pretrain.sh's flags at phase 23's batch and two epochs; later
    flags in ``extra`` override."""
    return ["--data_train", paths["train"], "--label_csv", paths["labels"],
            *PRETRAIN_FLAGS, "--batch_size", str(PRETRAIN_CLI_BATCH),
            "--epochs", "2", "--output_dir", out, *extra]


@contextlib.contextmanager
def _pretrain_cli_recording(qa, wa, calls, rec):
    """Time and count the pretrain CLI's steps without touching the CLI:
    ``engine.pretrain.make_mae_train_step``'s step is wrapped (synchronised
    ms, launch counts, recorded launches, batch rows per step) and the host
    loader's ``__iter__`` times the wait for each batch."""
    from tpat_tpu_torch.data import loader as loader_lib
    from tpat_tpu_torch.engine import pretrain

    make_step = pretrain.make_mae_train_step
    iterate = loader_lib.DataLoader.__iter__

    def counts():
        return _pretrain_counts(qa, wa)

    def timed_make(*a, **kw):
        step = make_step(*a, **kw)

        def timed(loss_sum, i, x, **kw2):
            torch.cuda.synchronize()
            c0, i0, t0 = counts(), len(calls), time.perf_counter()
            out = step(loss_sum, i, x, **kw2)
            torch.cuda.synchronize()
            rec["steps"].append(((time.perf_counter() - t0) * 1e3,
                                 tuple(a - b for a, b in zip(counts(), c0)),
                                 tuple(calls[i0:]), x.shape[0]))
            return out

        return timed

    def waited(self):
        it = iterate(self)
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            rec["wait_ms"].append((time.perf_counter() - t) * 1e3)
            yield item

    pretrain.make_mae_train_step = timed_make
    loader_lib.DataLoader.__iter__ = waited
    try:
        with _recording(qa, calls), _window_recording(wa, calls):
            yield
    finally:
        pretrain.make_mae_train_step = make_step
        loader_lib.DataLoader.__iter__ = iterate


def _pretrain_cli_run(argv, decoder_mode, what):
    """One ``cli.pretrain.main`` on the card with the launch counters at 0
    before it and read after it: each step's launches against
    ``PRETRAIN_CLI_LAUNCHES``, every step's recorded geometry the same (per
    batch size), the encoder's at N = PRETRAIN_ENC_N.  Returns (the epoch
    losses, the record, the run's launches, wall s, one step's walk)."""
    from tpat_tpu_torch.cli import pretrain as cli_pretrain
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.ops import window_attention as wa

    calls, rec = [], {"steps": [], "wait_ms": []}
    with _pretrain_cli_recording(qa, wa, calls, rec):
        qa.launches = qa.prefix_launches = 0  # the main path starts here
        qa.bwd_rows_launches = qa.bwd_cols_launches = 0
        _zero_window(wa)
        _gelu_zero()
        t0 = time.perf_counter()
        losses = cli_pretrain.main(cli_pretrain.get_args_parser().parse_args(argv))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _pretrain_counts(qa, wa)  # the main path ends here
        _gelu_read("pretrain CLI")
    if qa.prefix_launches:
        raise AssertionError(f"{what}: the prefix kernel ran")
    want = PRETRAIN_CLI_LAUNCHES[decoder_mode]
    walk = None
    for i, (_ms, got, step_calls, rows) in enumerate(rec["steps"]):
        if got != want:
            raise AssertionError(f"{what} step {i}: launches {got}, expected {want}")
        if walk is None:
            walk = step_calls
        if len(step_calls) != len(walk) or any(
                a[:1] + a[2:] != b[:1] + b[2:] for a, b in zip(step_calls, walk)):
            raise AssertionError(f"{what}: steps launched at other geometries")
        for c in step_calls:
            if c[0] in ("fwd", "bwd") and c[5] == 12 and c[2] != PRETRAIN_ENC_N:
                raise AssertionError(f"{what}: encoder launch at N = {c[2]}")
            if c[0] in ("fwd", "bwd") and c[5] == 16 and c[2] != DEC0_N:
                raise AssertionError(f"{what}: decoder launch at N = {c[2]}")
    summed = tuple(sum(s[1][k] for s in rec["steps"])
                   for k in range(len(launches)))
    if summed != launches:
        raise AssertionError(f"{what}: launches {launches}, steps account for "
                             f"{summed}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{what}: losses {losses}")
    return losses, rec, launches, wall, walk


def _epochs_logged(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _run_summary(rec) -> dict:
    """Steady step ms (median of the steps after the first of the run), the
    first step's and the last's (by then the loader has no batch left to
    make, so nothing runs beside it), the loader wait per batch and its
    share of the loop."""
    import numpy as np

    ms = [s[0] for s in rec["steps"]]
    wait = sum(rec["wait_ms"])
    return {"step_ms": float(np.median(ms[1:] if len(ms) > 1 else ms)),
            "first_ms": ms[0], "last_ms": ms[-1],
            "wait_ms": wait / len(rec["wait_ms"]),
            "wait_share": wait / (wait + sum(ms))}


def d32_grid_vs_plain() -> float:
    """B1, B2 and B3 at head_dim 32 vs plain at B=2 (H=16, N 513, 90 and
    33), every mode, f32 and bf16: the forward and the prefix forward at a
    middle kv_valid, the backward with and without a score cotangent,
    prefix (middle kv_valid) and not."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    worst, cases = 0.0, 0
    for n in (513, 90, 33):
        for mode, extra in ((None, 1), ("patch_mean", 1), ("cls", 2)):
            mid = (extra + 1 + n) // 2
            for dt in (torch.float32, torch.bfloat16):
                qkv = torch.randn(2, n, 3 * 512, device="cuda",
                                  generator=gen).to(dt)
                for kv in (None, mid):
                    worst = max(worst, *_compare(qa, qkv, 16, mode, extra, kv))
                d_out = torch.randn(2, n, 512, device="cuda", generator=gen).to(dt)
                cots = [None] if mode is None else [
                    None, n * torch.randn(2, n - extra, device="cuda",
                                          generator=gen)]
                for kv in (None, mid):
                    for ds in cots:
                        worst = max(worst, _compare_bwd(qa, qkv, d_out, ds, 16,
                                                        mode, extra, kv))
                cases += 1
    log(f"head_dim 32 vs plain at B=2: {cases} inputs (forward, prefix "
        f"forward, backward), worst abs err {worst:.3g}")
    _lse_log("phase 23's B=2 grid")
    return worst


def d32_calls(walk) -> tuple:
    """The head_dim-32 B1-B3 launches of a recorded decoder-0 step."""
    return tuple(c for c in walk
                 if c[0] in ("fwd", "bwd") and c[3] // 3 // c[5] == 32)


def d32_path_vs_plain(walk) -> tuple:
    """B1 and B3 at each recorded head_dim-32 geometry of a decoder-0 step:
    ``path_kernels_vs_plain`` (bf16, compared, timed in turns beside the
    library call and the bound), then the same geometries in f32 against
    plain.  Returns (the per-step sums, {kernel: worst error})."""
    from tpat_tpu_torch.ops import qkv_attention as qa

    d32 = d32_calls(walk)
    if len(d32) != 32:
        raise AssertionError(f"decoder-0 step: {len(d32)} head_dim 32 launches")
    sums, worst = path_kernels_vs_plain({"decoder-0 step": d32})
    gen = torch.Generator(device="cuda").manual_seed(SEED + 24)
    for call in sorted(set(d32), key=str):
        kind, b, n, c3, _dt, h, mode, extra, kv, has_ds = call
        qkv = torch.randn(b, n, c3, device="cuda", generator=gen)
        if kind == "fwd":
            worst["B1"] = max(worst["B1"], *_compare(qa, qkv, h, mode, extra, kv))
        else:
            d_out = torch.randn(b, n, c3 // 3, device="cuda", generator=gen)
            worst["B3"] = max(worst["B3"], _compare_bwd(
                qa, qkv, d_out, None, h, mode, extra, kv))
    log(f"head_dim 32 at the decoder-0 geometries (B={d32[0][1]}, N="
        f"{d32[0][2]}, H={d32[0][5]}), bf16 and f32 vs plain: worst abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in worst.items() if k != "B2"))
    return sums["decoder-0 step"], worst


def pretrain_step_f32_dec0():
    """One f32 decoder-0 pretrain step at the AudioSet grid under
    run_pretrain.sh's masking, the attention kernels vs plain attention
    (``attention_impl='xla'`` in every block), from the same seeded weights,
    batch and step generator: the loss within STEP_LOSS_RTOL, every
    gradient within GRAD_F32_REL of its largest entry."""
    from tpat_tpu_torch.cli import profile_pretrain as pp
    from tpat_tpu_torch.engine import pretrain
    from tpat_tpu_torch.models.vit import Block

    res = {}
    for impl in ("fused", "xla"):
        cfg = dataclasses.replace(pp.pretrain_config(1024, "auto", "float32"),
                                  decoder_mode=0, mask_2d=True,
                                  norm_pix_loss=True)
        model, _ = pp.build(cfg, seed=SEED)
        for blk in model.modules():
            if isinstance(blk, Block):
                blk.attn.cfg = dataclasses.replace(blk.attn.cfg,
                                                   attention_impl=impl)
        model.train()
        x = pp.synthetic_batch(cfg, STEP_BATCH_F32, seed=SEED + 8)
        gen = pretrain.step_generator(SEED, 0, "cuda")
        loss, _, _ = model(x, pp.MASK_RATIO, generator=gen)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, [p for _, p in named])
        res[impl] = (loss.item(), dict(zip((n for n, _ in named), grads)))
        del model
        torch.cuda.empty_cache()
    (lk, gk), (lx, gx) = res["fused"], res["xla"]
    if not abs(lk - lx) <= STEP_LOSS_RTOL * abs(lx):
        raise AssertionError(f"decoder-0 f32 loss {lk} vs {lx} (xla)")
    worst = 0.0
    for k, g in gx.items():
        err = (gk[k] - g).abs().max().item()
        scale = g.abs().max().item()
        if not err <= GRAD_F32_REL * scale:
            raise AssertionError(f"decoder-0 grad {k} err {err:.3g} > "
                                 f"{GRAD_F32_REL} x {scale:.3g}")
        worst = max(worst, err / scale if scale else 0.0)
    log(f"f32 decoder-0 pretrain step, AudioSet grid, b{STEP_BATCH_F32}, "
        f"2D masking: loss {lk:.7f} vs {lx:.7f} (xla); {len(gx)} parameter "
        f"gradients, worst err / max|grad| {worst:.3g}")


def pretrain_chain(pth, corpus, tmp, smi):
    """The exported mae_pretrained.pth into the finetune CLI's model
    (``cli.finetune.initial_state_dict``: the trunk through
    ``audiomae_state_dict_for``, the pos embed time-cropped from the 64 x 8
    grid to 32 x 8) at ft_esc50.sh's configuration, then one b128 bf16 eval
    forward: finite (128, 50) logits, 12 B1 launches."""
    from tpat_tpu_torch import config as cfg_lib
    from tpat_tpu_torch.cli import finetune
    from tpat_tpu_torch.models import pos_embed as pe
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.utils.weights import load_pth

    args = finetune.get_args_parser().parse_args(
        finetune_argv(corpus, os.path.join(tmp, "chain_out"))
        + ["--audioset_pretrained_model_path", pth])
    cfg = cfg_lib.audiomae_vit_base(
        num_classes=FINETUNE_CLASSES, target_length=512, drop_loc=(3, 6, 9),
        base_keep_rate=0.7, compute_dtype="bfloat16")
    sd = finetune.initial_state_dict(args, cfg)
    src = load_pth(pth)
    want = pe.crop_time_audio_pos_embed(src["pos_embed"].numpy(), (8, 64),
                                        (8, 32), num_extra_tokens=1)
    if not torch.equal(sd["pos_embed"], torch.from_numpy(want)):
        raise AssertionError("chain: the finetune pos embed is not the "
                             "cropped pretrain table")
    if not torch.equal(sd["blocks.11.mlp.fc2.weight"],
                       src["blocks.11.mlp.fc2.weight"]):
        raise AssertionError("chain: the pretrained trunk did not land")
    model = AudioViT(cfg, device="cuda")
    model.load_state_dict(sd, strict=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 25)
    x = torch.randn(FINETUNE_BATCH, 1, 512, 128, device="cuda", generator=gen)
    c0 = qa.launches
    with torch.no_grad():
        logits = model.eval()(x)
    torch.cuda.synchronize()
    if (tuple(logits.shape) != (FINETUNE_BATCH, FINETUNE_CLASSES)
            or not torch.isfinite(logits.float()).all()):
        raise AssertionError(f"chain logits {tuple(logits.shape)}")
    if qa.launches - c0 != 12:
        raise AssertionError(f"chain forward: {qa.launches - c0} B1 launches")
    log(f"pretrain -> finetune chain: mae_pretrained.pth into ft_esc50.sh's "
        f"ViT-B (pos embed cropped 64 x 8 -> 32 x 8, head fresh), one "
        f"b{FINETUNE_BATCH} bf16 eval forward: finite logits, 12 B1 "
        f"launches ({smi})")


def pretrain_cli_path(tmp, ft_corpus, smi):
    """Phase 23.  Returns ((fwd, bwd rows, bwd cols) launches of its runs,
    the decoder-0 D32 sums, the D32 worst errors, the decoder-0 runs'
    (fwd, rows, cols) launches, the decoder-0 step's head_dim-32
    launches)."""
    import numpy as np

    t_phase = time.perf_counter()
    paths = pretrain_corpus(os.path.join(tmp, "audioset"))
    log(f"pretrain corpus: {PRETRAIN_CLIPS} clips of {PRETRAIN_SECONDS} s, "
        f"{AUDIOSET_CLASSES} classes, written in "
        f"{time.perf_counter() - t_phase:.1f} s")
    log(f"pretrain CLI cuts of run_pretrain.sh: {PRETRAIN_CUTS}")
    grid_err = d32_grid_vs_plain()
    out = os.path.join(tmp, "pre_out")
    runs = {}
    total = [0] * len(PRETRAIN_CLI_LAUNCHES[0])

    def run(label, argv, decoder_mode, epochs):
        res = _pretrain_cli_run(argv, decoder_mode, label)
        logged = _epochs_logged(argv[argv.index("--output_dir") + 1])
        if [e["epoch"] for e in logged] != epochs or not all(
                math.isfinite(e["loss"]) for e in logged):
            raise AssertionError(f"{label}: log {logged}")
        runs[label] = res
        for k in range(len(total)):
            total[k] += res[2][k]
        s = _run_summary(res[1])
        log(f"pretrain {label}: epochs {[e['epoch'] for e in logged]} losses "
            f"{[round(e['loss'], 5) for e in logged]}; {len(res[1]['steps'])} "
            f"steps of b{res[1]['steps'][0][3]}, ms per step {s['step_ms']:.1f}"
            f" median (first {s['first_ms']:.1f}, last {s['last_ms']:.1f}); loader "
            f"wait "
            f"{s['wait_ms']:.1f} ms per batch, {s['wait_share']:.3f} of the "
            f"loop; {res[3]:.1f} s wall; launches (B1, B3 rows, B3 cols, B5 "
            f"fwd, B6 fwd, B5 bwd, B6 bwd) {res[2]} ({smi})")
        return res

    run("run 1 (2 epochs)", pretrain_argv(paths, out), 1, [0, 1])
    for name in ("checkpoint-001", "mae_pretrained.pth"):
        if not os.path.isfile(os.path.join(out, name)):
            raise AssertionError(f"pretrain wrote no {name}")
    run("run 2 (resume to 3)", pretrain_argv(
        paths, out, "--epochs", "3", "--resume",
        os.path.join(out, "checkpoint-001")), 1, [0, 1, 2])
    pth = os.path.join(out, "mae_pretrained.pth")
    run("run 3 (.pth resume)", pretrain_argv(
        paths, os.path.join(tmp, "pre_pth"), "--epochs", "1", "--resume", pth),
        1, [0])
    dec0 = run("run 4 (decoder_mode 0)", pretrain_argv(
        paths, os.path.join(tmp, "pre_dec0"), "--epochs", "1",
        "--decoder_mode", "0", "--export_torch", "false"), 0, [0])
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    full = run("run 5 (one b256 step)", pretrain_argv(
        paths, os.path.join(tmp, "pre_b256"), "--epochs", "1",
        "--batch_size", str(PRETRAIN_FULL_BATCH), "--export_torch", "false",
        "--save_every_epochs", "0"), 1, [0])
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    if [s[3] for s in full[1]["steps"]] != [PRETRAIN_FULL_BATCH]:
        raise AssertionError(f"b256 run: steps {[s[3] for s in full[1]['steps']]}")
    log(f"pretrain b{PRETRAIN_FULL_BATCH} step (run_pretrain.sh's batch): "
        f"{full[1]['steps'][0][0]:.1f} ms, peak memory {peak:.2f} GiB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f} "
        f"(model, optimizer and activations) ({smi})")
    pretrain_chain(pth, ft_corpus, tmp, smi)
    for d in ("pre_pth", "pre_dec0", "pre_b256"):
        shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()

    d32_sums, d32_err = d32_path_vs_plain(dec0[4])
    for k in ("B1", "B2", "B3"):  # the B=2 grid: forward, prefix, backward
        d32_err[k] = max(d32_err[k], grid_err)
    pretrain_step_f32_dec0()
    log(f"phase 23: {time.perf_counter() - t_phase:.1f} s; launches of its "
        f"runs (B1, B3 rows, B3 cols, B5 fwd, B6 fwd, B5 bwd, B6 bwd, FMA) "
        f"{tuple(total)}; decoder-0 run {dec0[2]}; median step ms "
        + ", ".join(f"{k}: {np.median([s[0] for s in v[1]['steps']]):.1f}"
                    for k, v in runs.items()))
    return tuple(total), d32_sums, d32_err, dec0[2]


# ---------------------------------------------------------------------------
# Phase 24: the device dataset cache in phase 22's run
# ---------------------------------------------------------------------------

# flags that make the train set eligible too: ft_esc50.sh's roll-mag off
# (with --device_frontend true, SpecAug runs on the device)
CACHE_ELIGIBLE = ("--roll_mag_aug", "false")


def _cached_run(tmp, paths, tag, extra, smi):
    """Phase 20's run with ``extra`` flags, the cache registry cleared
    first: (log lines, loader summary, eval ms median, {set: cached}, wall
    s)."""
    import numpy as np

    from tpat_tpu_torch.cli import finetune
    from tpat_tpu_torch.data import device_cache as dc
    from tpat_tpu_torch.ops import qkv_attention as qa

    out = os.path.join(tmp, f"cache_{tag}")
    argv = finetune_argv(paths, out) + ["--device_frontend", "true", *extra]
    cached = {}
    maybe = finetune.maybe_device_cached

    def recording(dataset, batch_size, **kw):
        got = maybe(dataset, batch_size, **kw)
        cached[kw["label"]] = got is not None
        return got

    dc.clear_cache()
    finetune.maybe_device_cached = recording
    calls, epochs, evals = [], [], []
    try:
        with _finetune_recording(qa, calls, epochs, evals):
            t0 = time.perf_counter()
            finetune.main(finetune.get_args_parser().parse_args(argv))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        finetune.maybe_device_cached = maybe
        dc.clear_cache()
    logs = _epochs_logged(out)
    shutil.rmtree(out, ignore_errors=True)
    summary = _loader_summary(epochs)
    eval_ms = float(np.median([ms for ms, _, _ in evals]))
    excess = [round(s[0] - s[1], 1) for s in summary["step_ms"]]
    waits = [w for rec in epochs for w in rec["wait_ms"]]
    log(f"device cache, {tag} ({' '.join(extra)}): cached {cached}; loader "
        f"wait {summary['wait_ms']:.1f} ms per batch (median "
        f"{np.median(waits):.1f}, the first {waits[0]:.1f}), "
        f"{summary['wait_share']:.3f} of the epochs; first-step excess per "
        f"epoch {excess} ms; eval "
        f"forwards {eval_ms:.2f} ms median of {len(evals)}; {wall:.1f} s wall "
        f"({smi})")
    return logs, summary, eval_ms, cached, wall


def device_cache_path(tmp, paths, smi):
    """Phase 24: phase 22's run (ft_esc50.sh's flags, ``--device_frontend
    true``) at ``--device_dataset auto`` (the eval set cached, the train set
    declined for roll-mag) and ``false``, then the pair again with
    ``CACHE_ELIGIBLE`` (both sets cached): per pair, the per-epoch losses
    within rel 1e-6 and the accuracies equal."""
    t0 = time.perf_counter()
    base = ("--device_dataset",)
    log(f"device cache: phase 22's run in pairs (auto, false), then with the "
        f"flags that make the train set eligible: {' '.join(CACHE_ELIGIBLE)}")
    for pair, extra, want in (
            ("ft_esc50", (), {"train set": False, "eval set": True}),
            ("eligible", CACHE_ELIGIBLE, {"train set": True, "eval set": True})):
        auto = _cached_run(tmp, paths, f"{pair} auto", (*extra, *base, "auto"), smi)
        off = _cached_run(tmp, paths, f"{pair} false", (*extra, *base, "false"), smi)
        if auto[3] != want or any(off[3].values()):
            raise AssertionError(f"{pair}: cached {auto[3]} (auto), "
                                 f"{off[3]} (false); expected {want}")
        for a, b in zip(auto[0], off[0]):
            for k in ("train_loss", "test_loss"):
                if not abs(a[k] - b[k]) <= 1e-6 * abs(b[k]):
                    raise AssertionError(f"{pair} epoch {a['epoch']}: {k} "
                                         f"{a[k]} cached vs {b[k]} streamed")
            if a["test_acc1"] != b["test_acc1"]:
                raise AssertionError(f"{pair} epoch {a['epoch']}: acc1 "
                                     f"{a['test_acc1']} vs {b['test_acc1']}")
        log(f"device cache, {pair}: losses within rel 1e-6 and accuracies "
            f"equal, cached vs streamed; eval ms median {auto[2]:.2f} vs "
            f"{off[2]:.2f}, loader-wait share {auto[1]['wait_share']:.3f} vs "
            f"{off[1]['wait_share']:.3f}, wall {auto[4]:.1f} vs {off[4]:.1f} s")
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 25: data parallelism across processes on the card
# ---------------------------------------------------------------------------

DP_RANKS = 2  # two processes on the one card, over gloo (NCCL refuses that)
DP_BATCH = 64  # rows per rank: ft_esc50.sh's b128 as two ranks' shards
DP_STEPS = ("dense_mask2d", "hybrid_0.8", "static")  # profile_train's variants
DP_SEED = 25
DP_DEVICE = "cuda"
DP_TIMEOUT = 420  # seconds the spawn of ranks may take before it is killed
# two ranks vs one process over the same global batches, per-step loss and
# final parameters (the L2 of the difference over the L2 of how far the
# parameters moved: AdamW's step on a gradient entry near 0 follows the
# summation order, so an entrywise bound would not hold); kept tokens equal
# in every row without a tie: a row whose gap between its k-th and
# (k+1)-th score (one process) exceeds twice the largest difference of its
# scores between the two runs, so that no reordering across the cut is
# possible
DP_TOL = {"bfloat16": {"loss_rtol": BF16_TOL, "param_rel": 0.1},
          "float32": {"loss_rtol": 1e-4, "param_rel": 1e-3}}
DP_DEPTH = {"bfloat16": (12, (3, 6, 9)), "float32": (4, (1, 2, 3))}
DP_WRITE_EVENTS = ("os.mkdir", "os.rmdir", "os.remove", "shutil.copyfile",
                   "os.rename")


def _dp_configs(dtype, world):
    """ft_esc50's configuration (phase 8's) at ``dtype`` and phase 25's depth,
    drop-path 0.1, ``DP_BATCH`` rows per rank of ``world``."""
    depth, drop_loc = DP_DEPTH[dtype]
    cfg, tc = _train_configs(dtype, 0.1)
    cfg = dataclasses.replace(cfg, depth=depth, drop_loc=drop_loc)
    tc = dataclasses.replace(tc, drop_loc=drop_loc,
                             batch_size=DP_BATCH * (DP_RANKS // world),
                             num_hosts=world)
    return cfg, tc


def _kept_ids(picked, kept, num_patches):
    """Each drop block's (kept patch ids sorted per row: the top-k indices
    composed through the earlier gathers, the first ``kept`` of them in the
    hybrid step; the patch ids of the block's input rows; its scores;
    the kept count)."""
    ids, out = None, []
    for (scores, idx), k in zip(picked, kept):
        if ids is None:
            ids = torch.arange(num_patches, device=idx.device).expand(
                idx.shape[0], -1)
        pos = ids
        ids = ids.gather(1, idx)
        k = idx.shape[1] if k is None else k
        out.append((ids[:, :k].sort(dim=1).values.cpu(), pos.cpu(),
                    scores.float().cpu(), k))
    return out


def _kept_rows_equal(one, mine, num_patches):
    """(rows without a tie, tied rows, tied rows keeping another token) of
    one rank's drop block against the one process's rows of it; raises if
    a row without a tie keeps another token.  A row is without a tie when
    the same tokens enter the block in both runs and the one process's gap
    at the cut exceeds twice the largest difference of the row's scores
    between the runs."""
    (ids_o, pos_o, s_o, k), (ids_r, pos_r, s_r, _) = one, mine

    def by_id(pos, sc):
        return torch.full((pos.shape[0], num_patches), math.nan).scatter(
            1, pos, sc)

    same_in = (pos_o.sort(1).values == pos_r.sort(1).values).all(1)
    noise = (by_id(pos_o, s_o) - by_id(pos_r, s_r)).abs().nan_to_num(
        0.0).amax(1)
    top = s_o.sort(1, descending=True).values
    gap = (top[:, k - 1] - top[:, k] if k < top.shape[1]
           else torch.full((top.shape[0],), math.inf))
    sure = same_in & (gap > 2 * noise)
    same = (ids_o == ids_r).all(1)
    if not bool(same[sure].all()):
        raise AssertionError(f"{int((~same & sure).sum())} rows without a "
                             "tie keep other tokens")
    return int(sure.sum()), int((~sure).sum()), int((~same & ~sure).sum())


def dp_engine_run(dtype, rank, world):
    """Phase 25.1's steps on one rank of ``world`` (one process: world 1):
    one dense step with 2D masking, one hybrid step at bucket 0.8 and one
    static step of ``TrainModule.train_step`` on the rank's rows of three
    seeded global batches of ``DP_BATCH * DP_RANKS``, with drop-path 0.1.
    Returns the per-step global losses and ms, the launches of the steps,
    the all-reduce ms, the kept ids and score gaps of every drop block, and
    the flat parameters before and after."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops import pruning
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.parallel import distributed as dist_lib
    from tpat_tpu_torch.parallel.mesh import rank_rows

    cfg, tc = _dp_configs(dtype, world)
    batch = tc.batch_size
    sd = sharpened_state_dict(AudioViT(cfg), DP_SEED)
    data = profile_train.synthetic_batches(cfg, DP_BATCH * DP_RANKS,
                                           len(DP_STEPS), DP_SEED, DP_DEVICE)
    mod = TrainModule(cfg, tc, "ce", iters_per_epoch=2, device=DP_DEVICE)
    state = mod.load(sd, seed=SEED)
    p0 = torch.cat([p.detach().reshape(-1).float() for p in state.params]).cpu()
    variants = profile_train.step_variants(cfg)
    acc = mod._zero_acc()
    picked, reduce_ms = [], []
    topk, reduce = pruning.topk_select, dist_lib.all_reduce_mean_

    def recording_topk(scores, k):
        idx = topk(scores, k)
        picked.append((scores.detach(), idx))
        return idx

    def timed_reduce(tensors):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(tensors)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)

    losses, step_ms, kept = [], [], []
    pruning.topk_select, dist_lib.all_reduce_mean_ = recording_topk, timed_reduce
    try:
        qa.launches = qa.prefix_launches = 0  # the path starts here
        qa.bwd_rows_launches = qa.bwd_cols_launches = 0
        for name, (x, y) in zip(DP_STEPS, data):
            kw = variants[name]
            picked.clear()
            before = acc["loss_sum"].item()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.train_step(state, acc, x[rank_rows(batch, rank)],
                           y[rank_rows(batch, rank)], **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(acc["loss_sum"].item() - before)
            drops = [kw["num_left"][i] if "num_left" in kw else None
                     for i in cfg.drop_loc] if kw["phase"] != "dense" else []
            kept.append(_kept_ids(picked, drops, cfg.num_patches))
        launches = _counts(qa)  # the path ends here
    finally:
        pruning.topk_select, dist_lib.all_reduce_mean_ = topk, reduce
    global_losses = torch.tensor(losses, device=DP_DEVICE)
    reduce([global_losses])  # each step's loss over the global batch
    p1 = torch.cat([p.detach().reshape(-1).float() for p in state.params]).cpu()
    del state, mod, data
    torch.cuda.empty_cache()
    return {"losses": global_losses.tolist(), "step_ms": step_ms,
            "reduce_ms": reduce_ms, "launches": launches, "kept": kept,
            "p0": p0, "p1": p1, "digest": _digest([p1]),
            "num_patches": cfg.num_patches}


def _audit_writes(prefix, log):
    """Record every write-mode open, directory made or removed, rename,
    removal and file copy under ``prefix`` (an audit hook: Python's, numpy's
    and the CLIs' writes all raise these events)."""
    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            path = path if writes else None
        elif event in DP_WRITE_EVENTS:
            path = args[1] if event in ("os.rename", "shutil.copyfile") else args[0]
        else:
            return
        if isinstance(path, (str, os.PathLike)) and os.fspath(path).startswith(
                prefix):
            log.append(f"{event} {os.fspath(path)}")

    sys.addaudithook(hook)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_counts(qa, wa) -> tuple:
    """(B1, B2, B3 rows, B3 cols, B5 fwd, B6 fwd, B5 bwd, B6 bwd, FMA fwd,
    FMA bwd) launches."""
    return _counts(qa) + _window_counts(wa)


def _dp_zero(qa, wa):
    qa.launches = qa.prefix_launches = 0
    qa.bwd_rows_launches = qa.bwd_cols_launches = 0
    _zero_window(wa)


def dp_cli_rank(task, out, argv):
    """One rank of phase 25.3/25.4: the CLI ``task`` (finetune, run_ast,
    pretrain) on ``argv``, with its launches counted from just before
    ``main`` to just after, its writes under its output directory audited
    and its final parameters' sha256; for finetune also phase 20's step and
    eval records, the eval ids each dist-eval pass read and the rows each
    gather returned."""
    from tpat_tpu_torch.cli import finetune, pretrain, run_ast
    from tpat_tpu_torch.engine import evaluate as eval_lib
    from tpat_tpu_torch.engine import pretrain as pretrain_lib
    from tpat_tpu_torch.engine import train as train_lib
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.ops import window_attention as wa

    cli = {"finetune": (finetune, finetune.get_args_parser, "--output_dir"),
           "run_ast": (run_ast, run_ast.get_parser, "--exp-dir"),
           "pretrain": (pretrain, pretrain.get_args_parser, "--output_dir")}
    module, parser, flag = cli[task]
    args = parser().parse_args(argv)
    writes, final, eval_ids, gathered = [], {}, [], []
    _audit_writes(os.path.abspath(getattr(args, flag.lstrip("-").replace(
        "-", "_"))), writes)
    make_step = pretrain_lib.make_mae_train_step
    dist_batches, allgather = finetune.dist_eval_batches, eval_lib.allgather_rows

    def keep_model(model, *a, **kw):
        final["params"] = list(model.parameters())
        return make_step(model, *a, **kw)

    def recorded_batches(*a, **kw):
        eval_ids.append([])
        for x, y, ids in dist_batches(*a, **kw):
            eval_ids[-1] += list(ids)
            yield x, y, ids

    def recorded_gather(arr):
        g = allgather(arr)
        gathered.append(int(g.shape[0]))
        return g

    epochs, evals, calls = [], [], []
    with _finetune_recording(qa, calls, epochs, evals):
        timed_epoch = train_lib.TrainModule.train_epoch

        def keep_state(self, state, *a, **kw):
            state, stats = timed_epoch(self, state, *a, **kw)
            final["params"] = state.params
            return state, stats

        train_lib.TrainModule.train_epoch = keep_state
        pretrain_lib.make_mae_train_step = keep_model
        finetune.dist_eval_batches = recorded_batches
        eval_lib.allgather_rows = recorded_gather
        try:
            _dp_zero(qa, wa)  # the path starts here
            t0 = time.perf_counter()
            ret = module.main(args)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = _dp_counts(qa, wa)  # the path ends here
        finally:
            train_lib.TrainModule.train_epoch = timed_epoch
            pretrain_lib.make_mae_train_step = make_step
            finetune.dist_eval_batches = dist_batches
            eval_lib.allgather_rows = allgather
    return {"ret": ret, "launches": launches, "writes": writes,
            "digest": _digest(final.get("params", [])), "wall_s": wall_s,
            "epochs": [{"epoch": rec["epoch"], "wait_ms": rec["wait_ms"],
                        "wall_ms": rec["wall_ms"],
                        "steps": [s[:2] for s in rec["steps"]]}
                       for rec in epochs],
            "evals": evals, "eval_ids": eval_ids, "gathered": gathered}


def dp_rank_main(task, out):
    """A rank of phase 25 (``python3 chip_smoke.py --dp-rank <task> <dir>``
    under ``torch.distributed.run``): joins the group on its card (gloo: the
    ranks share it), runs each of the '+'-joined tasks (``engine``, or a CLI
    on its argv in ``<dir>/argv.json``) in turn, saves their results to
    ``<dir>/rank<r>.pt``."""
    from tpat_tpu_torch.parallel import distributed as dist_lib

    torch.backends.cuda.matmul.allow_tf32 = False  # as check_device
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = dist_lib.init_distributed_mode(DP_DEVICE)
    with open(os.path.join(out, "argv.json")) as f:
        argvs = json.load(f)
    res = {}
    for t in task.split("+"):
        if t != "engine":
            res[t] = dp_cli_rank(t, out, argvs[t])
            continue
        res[t] = {d: dp_engine_run(d, rank, world) for d in DP_TOL}
        if rank:  # rank 0 returns the parameters for the comparison
            for r in res[t].values():
                r["p1"] = r["p0"] = None
    res.update(rank=rank, world=world, device=str(device),
               backend=torch.distributed.get_backend())
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist_lib.leave()


def dp_spawn(task, out, argvs=None, phase=25):
    """``DP_RANKS`` ranks of ``task`` under ``torch.distributed.run``, the
    CLIs' argv (``{cli: argv}``) handed over in ``<out>/argv.json``; every
    process of the spawn is killed if it outlives ``DP_TIMEOUT``.  Returns
    each rank's result and the spawn's seconds.  Phase 26's ranks run
    ``--tp-rank`` (its one task)."""
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "argv.json"), "w") as f:
        json.dump(argvs or {}, f)
    flag = ["--dp-rank", task] if phase == 25 else ["--tp-rank"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(DP_RANKS), os.path.abspath(__file__),
           *flag, out]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=DP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        text, _ = proc.communicate()
        raise AssertionError(f"phase {phase} {task}: the ranks outlived "
                             f"{DP_TIMEOUT} s and were killed:\n{text[-6000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
    if proc.returncode:
        raise AssertionError(f"phase {phase} {task}: rc {proc.returncode}:\n"
                             f"{text[-6000:]}")
    seconds = time.perf_counter() - t0
    res = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
           for r in range(DP_RANKS)]
    for r, x in enumerate(res):
        if (x["rank"], x["world"], x["backend"]) != (r, DP_RANKS, "gloo"):
            raise AssertionError(f"phase {phase} {task}: rank {r} ran as {x}")
    return res, seconds


def dp_engine_check(one, ranks, smi) -> tuple:
    """Phase 25.1: ``dp_engine_run`` in one process (``one``) and on two
    ranks (``ranks``, each on its 64 rows): the ranks' launches equal to the
    one process's, their losses and parameters equal to each other, and to
    the one process's within ``DP_TOL``, the kept tokens equal in every row
    without a tie.  Returns the ranks' summed launches."""
    from tpat_tpu_torch.parallel.mesh import rank_rows

    ranks = [r["engine"] for r in ranks]
    total = [0] * 4
    for dtype, tol in DP_TOL.items():
        o, rs = one[dtype], [r[dtype] for r in ranks]
        for r, x in enumerate(rs):
            if x["launches"] != o["launches"]:
                raise AssertionError(f"25.1 {dtype}: rank {r} launched "
                                     f"{x['launches']}, one process "
                                     f"{o['launches']}")
            total = [a + b for a, b in zip(total, x["launches"])]
        if rs[0]["losses"] != rs[1]["losses"] or rs[0]["digest"] != rs[1]["digest"]:
            raise AssertionError(f"25.1 {dtype}: the ranks differ")
        rel = [abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], o["losses"])]
        if not max(rel) <= tol["loss_rtol"]:
            raise AssertionError(f"25.1 {dtype}: losses {rs[0]['losses']} vs "
                                 f"one process {o['losses']}")
        if not torch.equal(rs[0]["p0"], o["p0"]):
            raise AssertionError(f"25.1 {dtype}: the ranks started elsewhere")
        moved = (o["p1"] - o["p0"]).norm().item()
        param_rel = (rs[0]["p1"] - o["p1"]).norm().item() / moved
        if not (moved > 0 and param_rel <= tol["param_rel"]):
            raise AssertionError(f"25.1 {dtype}: parameters differ by "
                                 f"{param_rel:.3g} of the {moved:.3g} moved")
        clear = tied = tied_other = 0
        for step, blocks in enumerate(o["kept"]):
            for block, one_block in enumerate(blocks):
                for r, x in enumerate(rs):
                    rows = rank_rows(DP_BATCH, r)
                    one_rows = tuple(t[rows] if torch.is_tensor(t) else t
                                     for t in one_block)
                    try:
                        c, t, d = _kept_rows_equal(
                            one_rows, x["kept"][step][block],
                            o["num_patches"])
                    except AssertionError as e:
                        raise AssertionError(
                            f"25.1 {dtype} {DP_STEPS[step]} drop block "
                            f"{block}, rank {r}: {e}") from None
                    clear, tied, tied_other = (clear + c, tied + t,
                                               tied_other + d)
        log(f"25.1 {dtype} depth {DP_DEPTH[dtype][0]}, {DP_RANKS} ranks x "
            f"b{DP_BATCH} vs one process b{DP_BATCH * DP_RANKS} "
            f"({', '.join(DP_STEPS)}): losses {rs[0]['losses']} vs "
            f"{o['losses']} (worst rel {max(rel):.3g}, limit "
            f"{tol['loss_rtol']}); parameters differ by {param_rel:.3g} of "
            f"the L2 they moved (limit {tol['param_rel']}); kept tokens "
            f"equal in {clear} rows without a tie, "
            f"{tied_other} of {tied} tied rows keep another token; launches "
            f"(B1, B2, B3 rows, B3 cols) per rank {rs[0]['launches']} = one "
            f"process's {o['launches']}; step ms rank 0 "
            f"{[round(v, 1) for v in rs[0]['step_ms']]}, rank 1 "
            f"{[round(v, 1) for v in rs[1]['step_ms']]}, one process "
            f"{[round(v, 1) for v in o['step_ms']]}; gradient all-reduce ms "
            f"rank 0 {[round(v, 1) for v in rs[0]['reduce_ms']]}, rank 1 "
            f"{[round(v, 1) for v in rs[1]['reduce_ms']]} ({smi})")
    return tuple(total)


def dp_nccl_check(smi):
    """Phase 25.2: two static b64 bf16 steps (the second at a non-zero lr)
    without a process group, then inside a one-rank NCCL group on the card,
    whose broadcast of the weights and all-reduce of the gradients run on
    the NCCL backend: the parameters after equal bit for bit (cuDNN's
    deterministic algorithms on for both)."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.parallel import distributed as dist_lib

    cfg, tc = _dp_configs("bfloat16", DP_RANKS)
    sd = sharpened_state_dict(AudioViT(cfg), DP_SEED)
    batches = profile_train.synthetic_batches(cfg, DP_BATCH, 2, DP_SEED,
                                              DP_DEVICE)
    seen = []
    all_reduce = torch.distributed.all_reduce

    def recorded(t, *a, **kw):
        seen.append((t.device.type, torch.distributed.get_backend()))
        return all_reduce(t, *a, **kw)

    def steps():
        mod = TrainModule(cfg, tc, "ce", iters_per_epoch=2, device=DP_DEVICE)
        state = mod.load(sd, seed=SEED)
        acc = mod._zero_acc()
        for x, y in batches:
            mod.train_step(state, acc, x, y, "static")
        return _digest(state.params), acc["loss_sum"].item()

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        alone = steps()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        rank, world, device = dist_lib.init_distributed_mode(
            DP_DEVICE, rank=0, world=1, address=f"127.0.0.1:{port}",
            local_rank=0, local_world=1)
        torch.distributed.all_reduce = recorded
        try:
            grouped = steps()
        finally:
            torch.distributed.all_reduce = all_reduce
            backend = torch.distributed.get_backend()
            dist_lib.leave()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    grad_reduces = [b for b in seen if b == ("cuda", "nccl")]
    if backend != "nccl" or len(grad_reduces) < 2 or (rank, world) != (0, 1):
        raise AssertionError(f"25.2: backend {backend}, all-reduces {seen}")
    if grouped != alone:
        raise AssertionError(f"25.2: inside the NCCL group {grouped}, "
                             f"alone {alone}")
    log(f"25.2: a one-rank NCCL group on {device}: {len(grad_reduces)} "
        f"gradient all-reduces on CUDA tensors over NCCL; two static b"
        f"{DP_BATCH} bf16 steps give the parameters (sha256 "
        f"{grouped[0][:16]}) and losses of the run without a group, bit for "
        f"bit ({smi})")


def dp_finetune_check(spawned, argv, walks, ft_launches, ft_summary,
                      smi) -> tuple:
    """Phase 25.3: phase 20's finetune run on two ranks of b64 with
    ``--dist_eval``: each rank's launches are phase 20's and each step's
    those of phase 8's walk of its kind; each eval reads every clip once
    across the ranks and gathers the 200 rows; the ranks end with the same
    parameters; only rank 0 wrote; the log's phases; the best epoch's acc1
    equals a one-process ``--eval`` of best_model.  Returns the ranks'
    summed launches."""
    from tpat_tpu_torch.cli import finetune

    out = argv[argv.index("--output_dir") + 1]
    ranks = [dict(r["finetune"], rank=r["rank"]) for r in spawned]
    r0, r1 = ranks
    if r0["digest"] != r1["digest"] or r0["ret"] != r1["ret"]:
        raise AssertionError("25.3: the ranks end with other parameters")
    if r1["writes"] or not r0["writes"]:
        raise AssertionError(f"25.3: rank 1 wrote {r1['writes'][:5]}; rank 0 "
                             f"{len(r0['writes'])} writes")
    with open(os.path.join(out, "log.txt")) as f:
        logs = [json.loads(line) for line in f]
    if [e["train_phase"] for e in logs] != FINETUNE_PHASES:
        raise AssertionError(f"25.3: phases {[e['train_phase'] for e in logs]}")
    n_eval = FINETUNE_CLIPS[1]
    for r in ranks:
        if tuple(r["launches"][:4]) != tuple(ft_launches) or any(r["launches"][4:]):
            raise AssertionError(f"25.3: rank {r['rank']} launched "
                                 f"{r['launches']}, phase 20 {ft_launches}")
        for rec, label in zip(r["epochs"], FINETUNE_WALKS):
            for _ms, got in rec["steps"]:
                if tuple(got) != _walk_counts(walks[label]):
                    raise AssertionError(f"25.3: epoch {rec['epoch']} step "
                                         f"launched {got}")
        if r["gathered"] != [n_eval] * (2 * len(FINETUNE_PHASES)):
            raise AssertionError(f"25.3: gathered rows {r['gathered']}")
    for i, (a, b) in enumerate(zip(r0["eval_ids"], r1["eval_ids"])):
        if len(a) + len(b) != n_eval or len(set(a) | set(b)) != n_eval:
            raise AssertionError(f"25.3: eval {i} read {len(a)} + {len(b)} "
                                 f"clips, {len(set(a) | set(b))} distinct")
    if len(r0["eval_ids"]) != len(FINETUNE_PHASES):
        raise AssertionError(f"25.3: {len(r0['eval_ids'])} dist evals")
    best = r0["ret"]
    stats = finetune.main(finetune.get_args_parser().parse_args(
        argv + ["--eval", "--finetuned_model_path",
                os.path.join(out, "best_model"),
                "--result_path", os.path.join(out, "eval_result.txt")]))
    logged = logs[best["best_epoch"]]["test_acc1"]
    if stats["acc1"] != logged:
        raise AssertionError(f"25.3: one-process --eval of best_model acc1 "
                             f"{stats['acc1']}, the ranks' gathered {logged}")
    for r in ranks:
        for rec, e in zip(r["epochs"], logs):
            wait = sum(rec["wait_ms"])
            log(f"25.3 rank {r['rank']} epoch {rec['epoch']} "
                f"({e['train_phase']}): ms per step "
                f"{[round(s[0], 1) for s in rec['steps']]}; loader wait "
                f"{wait / rec['wall_ms']:.3f} of the epoch's "
                f"{rec['wall_ms']:.0f} ms (phase 20, one process at b"
                f"{FINETUNE_BATCH}: {ft_summary['epoch_ms'][rec['epoch']]:.0f}"
                f" ms) ({smi})")
    log(f"25.3: {DP_RANKS} ranks x b{DP_BATCH} with --dist_eval: launches per "
        f"rank {r0['launches'][:4]} = phase 20's; each of "
        f"{len(r0['eval_ids'])} evals read {n_eval} clips once across the "
        f"ranks and gathered {n_eval} rows; best acc1 {best['best_score']:.4f}"
        f" at epoch {best['best_epoch']} = one-process --eval "
        f"{stats['acc1']:.4f}; parameters sha256 {r0['digest'][:16]} on both;"
        f" rank 0 made {len(r0['writes'])} writes, rank 1 none; run "
        f"{r0['wall_s']:.1f} s")
    shutil.rmtree(out, ignore_errors=True)
    return tuple(a + b for a, b in zip(r0["launches"], r1["launches"]))


DP_CLI_FILES = {
    "run_ast": ("models/best_audio_model", "result.csv", "best_result.csv"),
    "pretrain": ("mae_pretrained.pth", "checkpoint-001", "log.txt"),
}


def dp_other_clis(spawned, argvs, smi) -> tuple:
    """Phase 25.4: ``run_ast`` (phase 21's flags and corpus) and ``pretrain``
    (phase 23's flags at decoder 1 and corpus) on two ranks for two epochs
    each: the same parameters on both ranks, rank-0-only files, kernels
    launched on both.  Returns the ranks' summed launches."""
    total = [0] * 10
    for task, files in DP_CLI_FILES.items():
        argv = argvs[task]
        ranks = [dict(r[task], rank=r["rank"]) for r in spawned]
        r0, r1 = ranks
        out = argv[argv.index("--exp-dir" if task == "run_ast"
                              else "--output_dir") + 1]
        missing = [f for f in files if not os.path.isfile(os.path.join(out, f))]
        if r0["digest"] != r1["digest"] or r0["ret"] != r1["ret"]:
            raise AssertionError(f"25.4 {task}: the ranks differ")
        if r1["writes"] or missing:
            raise AssertionError(f"25.4 {task}: rank 1 wrote "
                                 f"{r1['writes'][:5]}; missing {missing}")
        for r in ranks:
            n = r["launches"]
            used = [n[0], n[2], n[3]] + (
                [n[4] + n[5], n[6] + n[7]] if task == "pretrain" else [])
            if min(used) == 0:
                raise AssertionError(f"25.4 {task}: rank {r['rank']} "
                                     f"launched {r['launches']}")
            total = [a + b for a, b in zip(total, r["launches"])]
        log(f"25.4 {task}: {DP_RANKS} ranks, two epochs: launches per rank "
            f"(B1, B2, B3 rows, B3 cols, B5, B6, B5 bwd, B6 bwd, FMA, FMA bwd) "
            f"{r0['launches']} and {r1['launches']}; parameters sha256 "
            f"{r0['digest'][:16]} on both; rank 0 made {len(r0['writes'])} "
            f"writes, rank 1 none; run {r0['wall_s']:.1f} s ({smi})")
        shutil.rmtree(out, ignore_errors=True)
    return tuple(total)


def data_parallel_path(tmp, paths, walks, ft_launches, ft_summary, smi):
    """Phase 25.  Returns the launches (B1, B2, B3 rows, B3 cols, B5, B6, B5
    bwd, B6 bwd, FMA, FMA bwd) of every rank of its runs."""
    t0 = time.perf_counter()
    one = {d: dp_engine_run(d, 0, 1) for d in DP_TOL}
    pre_root = os.path.join(tmp, "audioset")
    argvs = {
        "finetune": finetune_argv(paths, os.path.join(tmp, "dp_ft_out"))
        + ["--batch_size", str(DP_BATCH), "--dist_eval"],
        "run_ast": ast_argv(paths, os.path.join(tmp, "ast_audioset.pth"),
                            os.path.join(tmp, "dp_ast_out"))
        + ["--n-epochs", "2"],
        "pretrain": pretrain_argv(
            {"train": os.path.join(pre_root, "as20k_16k.json"),
             "labels": os.path.join(pre_root, "class_labels_indices.csv")},
            os.path.join(tmp, "dp_pre_out")),
    }
    # one spawn of the ranks runs 25.1, 25.3 and 25.4 in turn: a spawn's
    # start-up (the processes, CUDA, the model's first build) costs ~20 s
    ranks, seconds = dp_spawn("+".join(["engine", *argvs]),
                              os.path.join(tmp, "dp"), argvs)
    log(f"phase 25: the spawn of the ranks took {seconds:.1f} s")
    engine = dp_engine_check(one, ranks, smi)
    dp_nccl_check(smi)
    ft = dp_finetune_check(ranks, argvs["finetune"], walks, ft_launches,
                           ft_summary, smi)
    other = dp_other_clis(ranks, argvs, smi)
    total = tuple(a + b + c for a, b, c in zip(engine + (0,) * 6, ft, other))
    log(f"phase 25: {time.perf_counter() - t0:.1f} s; launches of every rank "
        f"(B1, B2, B3 rows, B3 cols, B5, B6, B5 bwd, B6 bwd, FMA, FMA bwd) "
        f"{total}")
    return total


# ---------------------------------------------------------------------------
# Phase 26: tensor parallelism, two ranks of one model group on the card
# ---------------------------------------------------------------------------

TP_AXIS = 2  # model ranks: the two processes on the card (gloo), dp = 1
TP_BATCH = 32  # the global batch, held whole by both ranks of the group
TP_SEED = 26
TP_CLI_FLAGS = ("--batch_size", str(TP_BATCH), "--model_axis", str(TP_AXIS),
                "--epochs", "2", "--shrink_epochs", "0")  # dense, static


def _tp_configs(dtype):
    """Phase 25.1's configuration (drop-path 0.1, 'fused' attention) at
    ``dtype``, phase 25's depth, ``use_fused_layernorm=True``, a b32
    batch."""
    depth, drop_loc = DP_DEPTH[dtype]
    cfg, tc = _train_configs(dtype, 0.1)
    cfg = dataclasses.replace(cfg, depth=depth, drop_loc=drop_loc,
                              use_fused_layernorm=True)
    tc = dataclasses.replace(tc, drop_loc=drop_loc, batch_size=TP_BATCH,
                             num_hosts=1)
    return cfg, tc


def tp_engine_run(dtype, mesh=None):
    """Phase 26.1's steps (``DP_STEPS``) of ``TrainModule.train_step`` on
    three seeded b32 batches, on a rank of ``mesh``, whose ``TrainModule``
    forces the attention to 'xla', or in one process at 'xla' (``mesh``
    None).  Returns the per-step losses, ms and model-group all-reduce ms,
    the B1-B3, B4 and B-G launches of the steps, the kept ids of every drop
    block, and the flat parameters before and after (gathered under
    ``mesh``)."""
    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.models.vit import AudioViT
    from tpat_tpu_torch.ops import fast_gelu as fg
    from tpat_tpu_torch.ops import layernorm as ln
    from tpat_tpu_torch.ops import pruning
    from tpat_tpu_torch.ops import qkv_attention as qa
    from tpat_tpu_torch.parallel import sharding

    cfg, tc = _tp_configs(dtype)
    if mesh is None:
        cfg = dataclasses.replace(cfg, attention_impl="xla")
    sd = sharpened_state_dict(AudioViT(cfg), TP_SEED)
    data = profile_train.synthetic_batches(cfg, TP_BATCH, len(DP_STEPS),
                                           TP_SEED, DP_DEVICE)
    mod = TrainModule(cfg, tc, "ce", iters_per_epoch=2, device=DP_DEVICE,
                      mesh=mesh)
    state = mod.load(sd, seed=SEED)
    impl = mod.model_cfg.attention_impl
    variants = profile_train.step_variants(cfg)
    acc = mod._zero_acc()
    picked, reduce_ms = [], [0.0]
    topk, reduce = pruning.topk_select, sharding._all_reduce_f32

    def recording_topk(scores, k):
        idx = topk(scores, k)
        picked.append((scores.detach(), idx))
        return idx

    def timed_reduce(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = reduce(t, group)
        torch.cuda.synchronize()
        reduce_ms[0] += (time.perf_counter() - t0) * 1e3
        return out

    losses, step_ms, all_reduce_ms, kept = [], [], [], []
    pruning.topk_select, sharding._all_reduce_f32 = recording_topk, timed_reduce
    try:
        qa.launches = qa.prefix_launches = 0  # the path starts here
        qa.bwd_rows_launches = qa.bwd_cols_launches = 0
        ln.launches = ln.bwd_launches = 0
        fg.launches = fg.bwd_launches = 0
        for name, (x, y) in zip(DP_STEPS, data):
            kw = variants[name]
            picked.clear()
            reduce_ms[0] = 0.0
            before = acc["loss_sum"].item()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.train_step(state, acc, x, y, **kw)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            all_reduce_ms.append(reduce_ms[0])
            losses.append(acc["loss_sum"].item() - before)
            drops = [kw["num_left"][i] if "num_left" in kw else None
                     for i in cfg.drop_loc] if kw["phase"] != "dense" else []
            kept.append(_kept_ids(picked, drops, cfg.num_patches))
        launches = (_counts(qa) + (ln.launches, ln.bwd_launches)
                    + (fg.launches, fg.bwd_launches))  # ends here
    finally:
        pruning.topk_select, sharding._all_reduce_f32 = topk, reduce
    full = state.model.state_dict()
    if mesh is not None:
        full = sharding.all_gather_state_dict(full, mesh)
    p0 = torch.cat([v.reshape(-1).float() for v in sd.values()])
    p1 = torch.cat([full[k].reshape(-1).float().cpu() for k in sd])
    del state, mod, data, full
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms, "reduce_ms": all_reduce_ms,
            "launches": launches, "kept": kept, "p0": p0, "p1": p1,
            "digest": _digest([p1]), "num_patches": cfg.num_patches,
            "attention_impl": impl}


def tp_rank_main(out):
    """A rank of phase 26 (``python3 chip_smoke.py --tp-rank <dir>`` under
    ``torch.distributed.run``): joins the group on the card (gloo), makes
    the 1 x 2 mesh, runs 26.1's steps, then 26.2's CLI runs (their argv in
    ``<dir>/argv.json``), and saves its results to ``<dir>/rank<r>.pt``."""
    from tpat_tpu_torch.parallel import distributed as dist_lib
    from tpat_tpu_torch.parallel import sharding

    torch.backends.cuda.matmul.allow_tf32 = False  # as check_device
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = dist_lib.init_distributed_mode(DP_DEVICE)
    mesh = sharding.make_mesh_2d(world // TP_AXIS, TP_AXIS)
    with open(os.path.join(out, "argv.json")) as f:
        argvs = json.load(f)
    res = {"engine": {d: tp_engine_run(d, mesh) for d in DP_TOL},
           "finetune": dp_cli_rank("finetune", out, argvs["finetune"]),
           "eval": dp_cli_rank("finetune", out, argvs["eval"])}
    if rank:  # rank 0 returns the parameters for the comparison
        for r in res["engine"].values():
            r["p1"] = r["p0"] = None
    res.update(rank=rank, world=world, device=str(device),
               backend=torch.distributed.get_backend())
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist_lib.leave()


def tp_engine_check(one, ranks, smi) -> tuple:
    """Phase 26.1: ``tp_engine_run`` in one process (``one``) and on the
    two ranks of the model group: the attention 'xla' and no B1-B3 launch
    on either side, each rank's B4 and B-G launches equal to the one
    process's (B-G: one a block each way in bf16, none in f32), the
    per-step losses and the parameters within ``DP_TOL``, the ranks'
    losses and gathered parameters equal, the kept tokens equal in every
    row without a tie.  Returns the ranks' summed (B4 forward, B4 backward,
    B-G forward, B-G backward) launches."""
    ranks = [r["engine"] for r in ranks]
    total = [0, 0, 0, 0]
    for dtype, tol in DP_TOL.items():
        o, rs = one[dtype], [r[dtype] for r in ranks]
        for x in rs + [o]:
            if x["attention_impl"] != "xla" or any(x["launches"][:4]):
                raise AssertionError(f"26.1 {dtype}: {x['attention_impl']} "
                                     f"attention launched {x['launches']}")
        for r, x in enumerate(rs):
            if x["launches"] != o["launches"] or min(x["launches"][4:6]) == 0:
                raise AssertionError(f"26.1 {dtype}: rank {r} launched "
                                     f"{x['launches']}, one process "
                                     f"{o['launches']}")
            total = [a + b for a, b in zip(total, x["launches"][4:])]
        if rs[0]["losses"] != rs[1]["losses"] or rs[0]["digest"] != rs[1]["digest"]:
            raise AssertionError(f"26.1 {dtype}: the ranks differ")
        rel = [abs(a - b) / abs(b) for a, b in zip(rs[0]["losses"], o["losses"])]
        if not max(rel) <= tol["loss_rtol"]:
            raise AssertionError(f"26.1 {dtype}: losses {rs[0]['losses']} vs "
                                 f"one process {o['losses']}")
        if not torch.equal(rs[0]["p0"], o["p0"]):
            raise AssertionError(f"26.1 {dtype}: the ranks started elsewhere")
        moved = (o["p1"] - o["p0"]).norm().item()
        param_rel = (rs[0]["p1"] - o["p1"]).norm().item() / moved
        if not (moved > 0 and param_rel <= tol["param_rel"]):
            raise AssertionError(f"26.1 {dtype}: parameters differ by "
                                 f"{param_rel:.3g} of the {moved:.3g} moved")
        clear = tied = tied_other = 0
        for step, blocks in enumerate(o["kept"]):
            for block, one_block in enumerate(blocks):
                for r, x in enumerate(rs):
                    try:
                        c, t, d = _kept_rows_equal(
                            one_block, x["kept"][step][block],
                            o["num_patches"])
                    except AssertionError as e:
                        raise AssertionError(
                            f"26.1 {dtype} {DP_STEPS[step]} drop block "
                            f"{block}, rank {r}: {e}") from None
                    clear, tied, tied_other = (clear + c, tied + t,
                                               tied_other + d)
        log(f"26.1 {dtype} depth {DP_DEPTH[dtype][0]}, tp {TP_AXIS} x b"
            f"{TP_BATCH} vs one process at 'xla' ({', '.join(DP_STEPS)}), "
            f"use_fused_layernorm: losses {rs[0]['losses']} vs {o['losses']} "
            f"(worst rel {max(rel):.3g}, limit {tol['loss_rtol']}); "
            f"parameters differ by {param_rel:.3g} of the L2 they moved "
            f"(limit {tol['param_rel']}); kept tokens equal in {clear} rows "
            f"without a tie, {tied_other} of {tied} tied rows keep another "
            f"token; launches (B1, B2, B3 rows, B3 cols, B4 fwd, B4 bwd) per "
            f"rank {rs[0]['launches']} = one process's {o['launches']}; step "
            f"ms rank 0 {rs[0]['step_ms']}, rank 1 {rs[1]['step_ms']}, one "
            f"process {o['step_ms']}; model-group all-reduce ms per step "
            f"(gloo, through the host) rank 0 {rs[0]['reduce_ms']}, rank 1 "
            f"{rs[1]['reduce_ms']} ({smi})")
    return tuple(total)


def cli_model_cfg(argv):
    """The model configuration ``cli.finetune`` builds from ``argv``."""
    from tpat_tpu_torch import config as cfg_lib
    from tpat_tpu_torch.cli import finetune

    args = finetune.get_args_parser().parse_args(argv)
    preset = cfg_lib.DATASET_PRESETS[args.dataset]
    return getattr(cfg_lib, args.model)(
        num_classes=args.nb_classes,
        target_length=args.target_length or preset.target_length,
        drop_loc=tuple(ast.literal_eval(args.drop_loc)),
        base_keep_rate=args.base_keep_rate)


def tp_cli_check(spawned, argvs, smi):
    """Phase 26.2: the ranks' finetune run and ``--eval`` at ``--model_axis
    2``: the logged phases, the logged best acc1 equal to the eval's on
    both ranks, best_model loaded strict into a tp = 1 ``AudioViT``, rank 1
    wrote nothing, no B1-B3 launch."""
    from tpat_tpu_torch.models.vit import AudioViT

    argv = argvs["finetune"]
    out = argv[argv.index("--output_dir") + 1]
    ranks = [dict(r["finetune"], rank=r["rank"], eval=r["eval"])
             for r in spawned]
    r0, r1 = ranks
    if r0["ret"] != r1["ret"] or r1["writes"] or not r0["writes"]:
        raise AssertionError(f"26.2: returns {r0['ret']} and {r1['ret']}; "
                             f"rank 1 wrote {r1['writes'][:5]}")
    for r in ranks:
        if any(r["launches"]) or any(r["eval"]["launches"]):
            raise AssertionError(f"26.2: rank {r['rank']} launched "
                                 f"{r['launches']}, {r['eval']['launches']}")
    with open(os.path.join(out, "log.txt")) as f:
        logs = [json.loads(line) for line in f]
    if [e["train_phase"] for e in logs] != ["dense", "static"]:
        raise AssertionError(f"26.2: phases {[e['train_phase'] for e in logs]}")
    best = r0["ret"]
    logged = logs[best["best_epoch"]]["test_acc1"]
    evals = [r["eval"]["ret"]["acc1"] for r in ranks]
    if evals != [logged] * 2:
        raise AssertionError(f"26.2: --eval of best_model acc1 {evals}, "
                             f"logged {logged}")
    payload = torch.load(os.path.join(out, "best_model"), map_location="cpu",
                         weights_only=True)
    AudioViT(cli_model_cfg(argv)).load_state_dict(payload["model"], strict=True)
    for r in ranks:
        for rec, e in zip(r["epochs"], logs):
            log(f"26.2 rank {r['rank']} epoch {rec['epoch']} "
                f"({e['train_phase']}): ms per step "
                f"{[s[0] for s in rec['steps']]}; loader wait "
                f"{sum(rec['wait_ms']) / rec['wall_ms']:.3f} of the epoch's "
                f"{rec['wall_ms']} ms ({smi})")
    log(f"26.2: tp {TP_AXIS} x b{TP_BATCH}, two epochs: best acc1 "
        f"{best['best_score']} at epoch {best['best_epoch']} = --eval of "
        f"best_model on both ranks; best_model loads strict into a tp = 1 "
        f"AudioViT; rank 0 made {len(r0['writes'])} writes, rank 1 none; no "
        f"B1-B3 launch; run {r0['wall_s']} s, eval {r0['eval']['wall_s']} s")
    shutil.rmtree(out, ignore_errors=True)


def tensor_parallel_path(tmp, paths, smi):
    """Phase 26.  Returns the (B4 forward, B4 backward, B-G forward, B-G
    backward) launches of its ranks."""
    t0 = time.perf_counter()
    one = {d: tp_engine_run(d) for d in DP_TOL}
    out = os.path.join(tmp, "tp_ft_out")
    argv = finetune_argv(paths, out) + list(TP_CLI_FLAGS)
    argvs = {"finetune": argv,
             "eval": argv + ["--eval", "--finetuned_model_path",
                             os.path.join(out, "best_model")]}
    ranks, seconds = dp_spawn("tp", os.path.join(tmp, "tp"), argvs, phase=26)
    log(f"phase 26: the spawn of the ranks took {seconds:.1f} s")
    launches = tp_engine_check(one, ranks, smi)
    tp_cli_check(ranks, argvs, smi)
    log(f"phase 26: {time.perf_counter() - t0:.1f} s; B4 and B-G launches "
        f"of its ranks (B4 fwd, bwd, B-G fwd, bwd) {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 27: the polynomial GELU (B-G), kernels vs the eager ops
# ---------------------------------------------------------------------------

# the cells' fc1 outputs (B, N, 4C): the ESC-50 ViT at b128, N 257 and the
# pruned 90, its 16-clip request in bucket 32, the MAE encoder at b256, N 96
# and its swin decoder at N 512, 4C 2048
GELU_SHAPES = ((128, 257, 3072), (128, 90, 3072), (32, 257, 3072),
               (256, 96, 3072), (256, 512, 2048))
GELU_TIMED = (GELU_SHAPES[0], GELU_SHAPES[4])
GELU_ODD = (1, 7, 8 * 1001 + 3)
GELU_DESIGN = (
    "one kernel a direction, bf16 in and out: 16-byte ld.global.nc loads "
    "and 16-byte stores of 8 bf16, four vectors a thread loaded before any "
    "is computed, one CTA of 256 threads per 8192 elements, one templated "
    "stream for both directions, one element at a time for the tail, a "
    "view off 16 bytes copied by the wrapper first; f32 "
    "__fmul_rn/__fadd_rn in the eager ops' order (no FMA), the clamp by "
    "max.NaN/min.NaN, bit-equal to the eager ops")


def _gelu_same(got, want, what):
    """bf16 got and want bit for bit (NaN payloads included); raises with
    the count of elements that differ."""
    gi, wi = got.view(torch.int16), want.view(torch.int16)
    if got.shape != want.shape or not torch.equal(gi, wi):
        nan = torch.isnan(got) & torch.isnan(want)
        raise AssertionError(
            f"gelu {what}: {int((gi != wi).sum())} of {got.numel()} elements "
            f"differ in their bits ({int(((gi != wi) & nan).sum())} of them "
            "NaN in both)")


def _gelu_pair(fg, x, g, what):
    """``gelu_poly`` forward and backward on x (cotangent g) through the
    autograd Function against the eager ops, bit for bit; raises unless each
    direction launched its kernel once."""
    before = (fg.launches, fg.bwd_launches)
    xr = x.detach().requires_grad_()
    y = fg.gelu_poly(xr)
    (dx,) = torch.autograd.grad(y, xr, g)
    if (fg.launches - before[0], fg.bwd_launches - before[1]) != (1, 1):
        raise AssertionError(f"gelu {what}: the kernels were not launched")
    _gelu_same(y, fg.gelu_poly_fwd_plain(x), what + " forward")
    _gelu_same(dx, fg.gelu_poly_bwd_plain(x, g), what + " backward")


def _gelu_checkpoint(fg, gen):
    """fc1 -> gelu_poly -> fc2 in bf16 under ``torch.utils.checkpoint`` and
    without: the same bits in every gradient, and the recompute launches the
    forward kernel once more."""
    import torch.utils.checkpoint as cp

    h = torch.randn(4, 257, 768, device="cuda", generator=gen).bfloat16()
    w1, w2 = (torch.randn(*s, device="cuda", generator=gen).bfloat16() / 28
              for s in ((768, 3072), (3072, 768)))
    dy = torch.randn(4, 257, 768, device="cuda", generator=gen).bfloat16()

    def mlp(h, w1, w2):
        return fg.gelu_poly(h @ w1) @ w2

    grads, counts = [], []
    for checkpointed in (False, True):
        leaves = [t.detach().requires_grad_() for t in (h, w1, w2)]
        before = (fg.launches, fg.bwd_launches)
        out = (cp.checkpoint(mlp, *leaves, use_reentrant=False)
               if checkpointed else mlp(*leaves))
        grads.append(torch.autograd.grad(out, leaves, dy))
        counts.append((fg.launches - before[0], fg.bwd_launches - before[1]))
    for a, b, name in zip(*grads, ("h", "w1", "w2")):
        _gelu_same(b, a, f"checkpointed d{name}")
    if counts != [(1, 1), (2, 1)]:
        raise AssertionError(f"gelu under checkpoint: launches {counts}, "
                             "expected [(1, 1), (2, 1)]")


def _gelu_traced_step(fg):
    """One b128 bf16 static finetune step under ``torch.profiler``: the
    ``gelu_kernel`` share of ``train.forward``'s counts (1.0 when every call
    takes the kernel) and its elements against the MLPs' (B x the tokens
    each block keeps x 4C), and the device ms of the step's GELU kernels."""
    from torch.profiler import ProfilerActivity, profile

    from tpat_tpu_torch.cli import profile_train
    from tpat_tpu_torch.cli.profile_forward import kernel_rows
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.utils import tracing

    cfg, tc = profile_train.train_configs()
    mod = TrainModule(cfg, tc, "ce", 2)
    state, acc = mod.init(SEED), mod._zero_acc()
    (x, y), = profile_train.synthetic_batches(cfg, profile_train.TRAIN_BATCH,
                                              1, SEED + 27)
    mod.train_step(state, acc, x, y, phase="static")
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mod.train_step(state, acc, x, y, phase="static")
        torch.cuda.synchronize()
    counts = tracing.records("train.forward")[-1].counts
    kernel, eager = counts.get("gelu_kernel", 0), counts.get("gelu_eager", 0)
    share = kernel / max(kernel + eager, 1)
    rows = x.shape[0] * sum(out + cfg.num_extra_tokens
                            for _, out in cfg.tokens_per_block())
    if share != 1.0 or kernel != int(cfg.embed_dim * cfg.mlp_ratio) * rows:
        raise AssertionError(
            f"traced step: gelu_kernel {kernel}, gelu_eager {eager}, the "
            f"MLPs' rows {rows}")
    kernels = kernel_rows(prof, 1)
    ms = {k: sum(r["device_ms"] for r in kernels if k in r["name"]) or None
          for k in ("gelu_poly_fwd_kernel", "gelu_poly_bwd_kernel")}
    del mod, state, acc
    return {"share": share, "elements": kernel, "mlp_rows": rows,
            "device_ms": ms}


def gelu_path(smi) -> dict:
    """Phase 27: the GELU kernels against the eager ops, bit for bit, at
    every cell's fc1 shape, odd sizes, a view off 16 bytes, a
    non-contiguous gradient and inside ``torch.utils.checkpoint``; the
    ``gelu_kernel`` share of a traced finetune step; kernel, plain and
    library (``F.gelu`` and its backward, the exact-erf GELU the port never
    calls on these paths) ms beside the byte bound at the timed shapes.
    Returns the kernels line's two entries' fields."""
    from tpat_tpu_torch.ops import fast_gelu as fg

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 27)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    every = torch.arange(-32768, 32768, dtype=torch.int32, device="cuda")
    every = every.to(torch.int16).view(torch.bfloat16)
    _gelu_pair(fg, every, randn(every.numel()), "every bf16 value")
    for n in GELU_ODD:
        _gelu_pair(fg, randn(n) * 3, randn(n), f"n = {n}")
    n = GELU_ODD[-1]
    xb, gb = randn(n + 8) * 3, randn(n + 8)
    x, g = xb[1:n + 1], gb[3:n + 3]  # 2 and 6 bytes off 16
    if x.data_ptr() % 16 == 0 or g.data_ptr() % 16 == 0:
        raise AssertionError("the sliced views are 16-byte aligned")
    _gelu_pair(fg, x, g, "views off 16 bytes")
    _gelu_pair(fg, randn(3072, 257).t(), randn(3072, 257).t(),
               "non-contiguous x and gradient")
    _gelu_pair(fg, randn(257, 3072), randn(3072, 257).t(),
               "non-contiguous gradient")
    _gelu_checkpoint(fg, gen)
    log(f"gelu: kernels = eager bit for bit on every bf16 value, n in "
        f"{GELU_ODD}, views off 16 bytes, non-contiguous x and gradient, "
        "and under torch.utils.checkpoint")
    timed = {}
    for shape in GELU_SHAPES:
        x, g = randn(*shape) * 2, randn(*shape)
        _gelu_pair(fg, x, g, f"{shape}")
        if shape not in GELU_TIMED:
            continue
        n = x.numel()
        with torch.no_grad():
            for bwd in (False, True):
                if bwd:
                    kern = lambda: fg._backward_kernel(x, g)  # noqa: E731
                    plain = lambda: fg.gelu_poly_bwd_plain(x, g)  # noqa: E731
                    library = lambda: torch.ops.aten.gelu_backward(g, x)  # noqa: E731
                else:
                    kern = lambda: fg._forward_kernel(x)  # noqa: E731
                    plain = lambda: fg.gelu_poly_fwd_plain(x)  # noqa: E731
                    library = lambda: F.gelu(x)  # noqa: E731
                k, p = _turns(kern, plain)
                lib = _time_ms(library)
                # None where the profiler records no kernel, as late in
                # this long process it may
                dev = [_device_ms(f) or None for f in (kern, plain, library)]
                bnd = bound_ms((6 if bwd else 4) * n, 0.0, torch.bfloat16)
                key = f"{'bwd' if bwd else 'fwd'} {'x'.join(map(str, shape))}"
                timed[key] = dict(ms=k, plain_ms=p, library_ms=lib,
                                  bound_ms=bnd[0], of_bound=bnd[0] / k,
                                  device_ms=dev[0], plain_device_ms=dev[1],
                                  library_device_ms=dev[2])
                log(f"gelu {key} bf16: kernel {k:.4f} ms "
                    f"({100 * bnd[0] / k:.1f}% of bound), plain {p:.4f}, "
                    f"library {lib:.4f}, bound {bnd[0]:.4f} ({bnd[1]}); "
                    f"device ms (torch.profiler) kernel, plain, library "
                    f"{dev} ({smi})")
        del x, g
    log(f"gelu: kernels = eager bit for bit at {len(GELU_SHAPES)} fc1 "
        f"shapes {GELU_SHAPES}")
    step = _gelu_traced_step(fg)
    log(f"gelu: traced b128 static step: gelu_kernel share {step['share']}, "
        f"{step['elements']} elements = 3072 x the MLPs' rows "
        f"{step['mlp_rows']}; its GELU kernels' device ms "
        f"{step['device_ms']}")
    build = build_fields("gelu_poly", GELU_DESIGN, {
        "fwd": ("gelu_poly_fwd_kernel",), "bwd": ("gelu_poly_bwd_kernel",)})
    log(f"gelu: registers {build['registers']}, spill bytes "
        f"{build['spill_bytes']}; phase 27: {time.perf_counter() - t0:.1f} s")
    return {"timed": timed, "step": step, "build": build}


def main():
    with tempfile.TemporaryDirectory() as tmp:
        run_phases(tmp)


def run_phases(tmp):
    t_start = time.perf_counter()
    smi = check_device()
    build_kernels()
    grid_err = kernel_vs_plain()
    (ms, plain_ms, timed_err, serve_bound, serve_noscore,
     serve_device) = time_kernel()
    cfg, sd, serve_launches, out_dir = serving_path(tmp)
    if serve_launches == 0:
        raise AssertionError("the serving path launched no qkv_attention kernel")
    model_level(cfg, sd)
    prefix_err, bwd_err = prefix_and_bwd_vs_plain()
    train_launches, walks, train_step_ms = training_path(sd)
    if min(train_launches) == 0:
        raise AssertionError(f"training launches {train_launches}")
    sums, path_err = path_kernels_vs_plain(walks)
    train_step_f32(sd)
    win_err = window_vs_plain()
    pre_counts, pre_walks, _ = pretrain_path()
    pre_sums, pre_err = pretrain_kernels_vs_plain(pre_walks)
    pretrain_step_f32()
    ln_err = layernorm_vs_plain()
    ln_serve_launches, serve_calls, serve_walk = layernorm_serving(cfg, out_dir)
    ln_train_launches, ln_walks = layernorm_training(sd)
    train_step_f32(sd, LAYERNORM_PAIR, "fused vs plain LayerNorm")
    ln_per, ln_path_err = layernorm_at_path(
        serve_calls,
        [c for walk in (serve_walk, *ln_walks.values()) for c in walk])
    probe_err, probe_times, p3_identity = probes_vs_plain()
    p3_sass = sass_check("ln_matmul", "ln_matmul_bf16_tc_kernel")
    # a P1 kernel ('full', 64 rows, 1 head) and a P2 one (128 rows, 4 heads)
    p1_sass = sass_check("attn_probe", "attn_probe_bf16_kernelILi64ELi1ELi0E")
    p2_sass = sass_check("attn_probe", "attn_probe_bf16_kernelILi128ELi4ELi1E")
    probe_launches = probe_mains()
    finetune_launches, corpus, ft_loader = finetune_path(tmp, walks,
                                                         train_step_ms, smi)
    if min(finetune_launches) == 0:
        raise AssertionError(f"finetune launches {finetune_launches}")
    ast_launches, ast_walks = ast_path(tmp, corpus, smi)
    if min(ast_launches) == 0:
        raise AssertionError(f"AST launches {ast_launches}")
    ast_sums, ast_err = path_kernels_vs_plain(ast_walks)
    wave_launches = waveform_path(tmp, corpus, walks, ft_loader, out_dir, sd,
                                  smi)
    if min(wave_launches) == 0:
        raise AssertionError(f"waveform path launches {wave_launches}")
    pre_cli, d32, d32_err, dec0_launches = pretrain_cli_path(tmp, corpus,
                                                             smi)
    if min(pre_cli[:3]) == 0 or min(pre_cli[4], pre_cli[6]) == 0:
        raise AssertionError(f"pretrain CLI launches {pre_cli}")
    device_cache_path(tmp, corpus, smi)
    dp = data_parallel_path(tmp, corpus, walks, finetune_launches, ft_loader,
                            smi)
    tp = tensor_parallel_path(tmp, corpus, smi)
    gelu = gelu_path(smi)
    if LSE_CHECKS["count"] == 0:
        raise AssertionError("no row log-sum-exp L was held against plain")
    audioset, esc50 = pre_counts["AudioSet"], pre_counts["ESC-50"]
    window_launches = {"B5 fwd": esc50[3] + dp[4],
                       "B6 fwd": audioset[4] + pre_cli[4] + dp[5],
                       "B5 bwd": esc50[5] + dp[6],
                       "B6 bwd": audioset[6] + pre_cli[6] + dp[7]}
    window_dp = {"B5 fwd": dp[4], "B6 fwd": dp[5], "B5 bwd": dp[6],
                 "B6 bwd": dp[7]}
    if min(window_launches.values()) == 0:
        raise AssertionError(f"window kernel launches {window_launches}")
    for key in ("B5", "B6"):
        if not any(k.startswith(key) for k in WINDOW_REPEATS):
            raise AssertionError(f"no {key} backward was run twice")
    from tpat_tpu_torch.ops import window_attention as wa
    dev = torch.cuda.current_device()
    hopper_fields = {
        "B5": window_build(
            WINDOW_DENSE_BUILD,
            lambda bwd: wa._dense_library().tpat_window_attention_dense_smem(
                256, int(bwd))),
        "B6": window_build(
            WINDOW_BANDED_BUILD,
            lambda bwd: wa._banded_library().tpat_window_attention_banded_smem(
                int(bwd)))}
    hopper_slices = {
        "B5": {f"{d} B={PRETRAIN_BATCH} N=256 H=16": dict(zip(
            ("slices", "cluster"), wa.dense_slices(
                PRETRAIN_BATCH, 256, 16, d == "bwd", dev)))
               for d in ("fwd", "bwd")},
        "B6": {f"{d} B={PRETRAIN_BATCH} N=512 H=16": wa.banded_slices(
            PRETRAIN_BATCH, 512, 16, d == "bwd", dev) for d in ("fwd", "bwd")}}
    step = sums[EPOCH_LABELS[3]]
    per_step = "one b128 bf16 hybrid train step at bucket 0.8"
    bwd = "tpat_tpu/ops/pallas_attention.py:366"
    bwd_note = ("plain_ms, bound_ms and library_ms are of the whole backward, "
                "which the rows and cols kernels compute together; pair_ms is "
                "both kernels through fused_qkv_attention_bwd")
    b3_err = max(bwd_err, path_err["B3"], pre_err["B3"], ast_err["B3"],
                 d32_err["B3"])
    ast_step = ast_sums[f"AST b{AST_BATCH} hybrid train step"]
    ast_note = (f"ast_launches: phase 21's run_ast run (ast_run_esc.sh, b"
                f"{AST_BATCH}, 'cls' scores, 2 extra tokens); ast_ms: one "
                f"b{AST_BATCH} bf16 hybrid AST train step at bucket 0.9")
    b3 = dict(plain=step["B3"][3], bound=bound_of(step["B3bound"]),
              lib=step["B3lib"], per=per_step, pair_ms=step["B3"][2],
              note=bwd_note,
              library_backend=sorted(step["B3backends"]))
    fwd_build = bf16_build("qkv_attention", "qkv_attention_fwd")
    dec0_note = (
        "dec0_*: phase 23's head_dim 32 calls of one b32 bf16 decoder-0 "
        "pretrain step (16 blocks of the plain decoder, N = 513, H = 16, no "
        "scores), kernel, plain, SDPA and bound summed over the step; "
        "dec0_launches: the launches of phase 23's decoder-0 run; "
        "pretrain_cli_launches: those of all phase 23's runs (in launches "
        "too)")

    def dec0(key, ms_at, launches_at):
        bms, by = bound_of(d32[key + "bound"])
        return {"dec0_launches": dec0_launches[launches_at],
                "dec0_ms": d32[key][ms_at], "dec0_plain_ms": d32[key][-1],
                "dec0_library_ms": d32[key + "lib"], "dec0_bound_ms": bms,
                "dec0_bound_by": by,
                "pretrain_cli_launches": pre_cli[launches_at]}

    kernels = [
        _entry("qkv_attention_fwd", "qkv_attention.cu", "tpat_tpu/ops/pallas_attention.py:121",
               serve_launches + train_launches[0] + audioset[0] + esc50[0]
               + wave_launches[0] + pre_cli[0] + dp[0],
               max(grid_err, timed_err, path_err["B1"], pre_err["B1"],
                   ast_err["B1"], d32_err["B1"]),
               ms, plain_ms, bound_of(serve_bound), None,
               "one b128 bf16 serving forward (12 calls)",
               note="3 of the 12 calls (the drop blocks 3, 6, 9) emit "
                    "patch_mean scores, which no library call computes; the "
                    "9 without scores are timed against the library call in "
                    "phase 3 (noscore); ms by CUDA events around each "
                    "call's wrapper, which at N = 90 and 127 is paced by "
                    "the host's ~0.04-0.06 ms per call; device_ms is the "
                    "summed duration of the calls' kernels (torch.profiler); "
                    "lse_*: the row log-sum-exp L that the bf16 forward "
                    "writes for B3, in each B3 comparison's own mode and "
                    "prefix form (phases 7, 9, 14, 23), vs torch.logsumexp "
                    "of the plain f32 logits; "
                    + ast_note + "; " + dec0_note,
               noscore={"calls": 9, "ms": serve_noscore[0],
                        "library_ms": serve_noscore[1],
                        "device_ms": serve_noscore[2],
                        "library_device_ms": serve_noscore[3]},
               device_ms=serve_device,
               lse_checks=LSE_CHECKS["count"],
               lse_max_abs_err=LSE_CHECKS["worst"],
               finetune_launches=finetune_launches[0],
               waveform_launches=wave_launches[0], dp_launches=dp[0],
               ast_launches=ast_launches[0], ast_ms=ast_step["B1"][0],
               **dec0("B1", 0, 0), **fwd_build),
        _entry("qkv_attention_prefix_fwd", "qkv_attention.cu",
               "tpat_tpu/ops/pallas_attention.py:121",
               train_launches[1] + wave_launches[1] + dp[1],
               max(prefix_err, path_err["B2"], ast_err["B2"], d32_err["B2"]),
               step["B2"][0],
               step["B2"][1], bound_of(step["B2bound"]), step["B2lib"],
               per_step,
               noscore={"calls": step["B2noscore"][0],
                        "ms": step["B2noscore"][1],
                        "library_ms": step["B2noscore"][2]},
               note="library_ms is null: 2 of the step's 8 calls emit "
                    "patch_mean scores; noscore sums the calls without "
                    "scores, which SDPA with the key mask computes; ms "
                    "includes writing the row log-sum-exp the backward "
                    "reads; " + ast_note,
               finetune_launches=finetune_launches[1],
               waveform_launches=wave_launches[1], dp_launches=dp[1],
               ast_launches=ast_launches[1], ast_ms=ast_step["B2"][0],
               **fwd_build),
        _entry("qkv_attention_bwd_rows", "qkv_attention_bwd.cu", bwd,
               train_launches[2] + audioset[1] + esc50[1] + wave_launches[2]
               + pre_cli[1] + dp[2],
               b3_err,
               step["B3"][0], b3["plain"], b3["bound"], b3["lib"], per_step,
               pair_ms=b3["pair_ms"],
               note=bwd_note + "; " + ast_note + "; " + dec0_note,
               dec0_pair_ms=d32["B3"][2], **dec0("B3", 0, 1),
               library_backend=b3["library_backend"],
               finetune_launches=finetune_launches[2],
               waveform_launches=wave_launches[2], dp_launches=dp[2],
               ast_launches=ast_launches[2], ast_ms=ast_step["B3"][0],
               **bf16_build("qkv_attention_bwd", "qkv_attention_bwd_rows")),
        _entry("qkv_attention_bwd_cols", "qkv_attention_bwd.cu", bwd,
               train_launches[3] + audioset[2] + esc50[2] + wave_launches[3]
               + pre_cli[2] + dp[3],
               b3_err,
               step["B3"][1], b3["plain"], b3["bound"], b3["lib"], per_step,
               pair_ms=b3["pair_ms"],
               note=bwd_note + "; " + ast_note + "; " + dec0_note,
               dec0_pair_ms=d32["B3"][2], **dec0("B3", 1, 2),
               library_backend=b3["library_backend"],
               finetune_launches=finetune_launches[3],
               waveform_launches=wave_launches[3], dp_launches=dp[3],
               ast_launches=ast_launches[3], ast_ms=ast_step["B3"][1],
               **bf16_build("qkv_attention_bwd", "qkv_attention_bwd_cols")),
    ]
    for name, key, grid, replaces in (
            ("window_attention_dense_fwd", "B5 fwd", "ESC-50",
             "tpat_tpu/ops/pallas_window_attention.py:457"),
            ("window_attention_dense_bwd", "B5 bwd", "ESC-50",
             "tpat_tpu/ops/pallas_window_attention.py:491"),
            ("window_attention_banded_fwd", "B6 fwd", "AudioSet",
             "tpat_tpu/ops/pallas_window_attention.py:457"),
            ("window_attention_banded_bwd", "B6 bwd", "AudioSet",
             "tpat_tpu/ops/pallas_window_attention.py:222")):
        e = pre_sums[grid][key]
        fwd = key.endswith("fwd")
        kernel = key[:2]
        extra = {"library_backend": sorted(e["backends"]),
                 "dp_launches": window_dp[key], "device_ms": e["device_ms"],
                 "note": WINDOW_NOTE if fwd else WINDOW_BWD_NOTE,
                 "slices": hopper_slices[kernel]}
        if not fwd:
            extra["same_bits_twice"] = {
                k: v for k, v in WINDOW_REPEATS.items() if k.startswith(kernel)}
        source = ("window_attention_dense.cu" if kernel == "B5"
                  else "window_attention_banded.cu")
        fields = hopper_fields[kernel]
        kernels.append(_entry(
            name, source, replaces, window_launches[key],
            max(win_err[key], pre_err[key]), e["ms"], e["plain_ms"],
            bound_of(e["bound"]), e["library_ms"],
            f"one b{PRETRAIN_BATCH} bf16 MAE pretrain step at the {grid} grid "
            f"({e['calls']} calls)", **extra, **fields))
    ln_fwd = _sum_walk(ln_per, serve_walk)
    ln_bwd = _sum_walk(ln_per, [c for c in ln_walks[EPOCH_LABELS[4]]
                                if c[0] == "lnbwd"])
    for name, line, launches, tp_launches, err, e, per in (
            ("layernorm_fwd", 41, ln_serve_launches + ln_train_launches[0],
             tp[0], max(ln_err["fwd"], ln_path_err), ln_fwd,
             "one b128 bf16 serving forward (24 calls)"),
            ("layernorm_bwd", 53, ln_train_launches[1], tp[1],
             max(ln_err["bwd"], ln_path_err), ln_bwd,
             "one b128 bf16 static train step (24 calls)")):
        kernels.append(_entry(
            name, "layernorm.cu", f"tpat_tpu/ops/pallas_layernorm.py:{line}",
            launches + tp_launches, err, e["ms"], e["plain_ms"],
            bound_of(e["bound"]), e["library_ms"], per,
            tp_launches=tp_launches, **{k: e[k] for k in DEVICE_KEYS},
            note="ms, plain_ms and library_ms by CUDA events around each "
                 "call's wrapper, which for calls of tens of microseconds "
                 "include the host's launch rate; the *device_ms fields are "
                 "the summed kernel durations of the same calls "
                 "(torch.profiler)"))

    def probe_entry(name, source, replaces, key, err_key, per, **extra):
        k, p, lib, bnd = probe_times[key]
        return _entry(name, source, replaces, probe_launches[err_key],
                      probe_err[err_key], k, p, bnd, lib, per, **extra)

    def rows(prefix):
        return {key[len(prefix):]: {"ms": k, "plain_ms": p, "library_ms": lib,
                                    "bound_ms": bnd[0]}
                for key, (k, p, lib, bnd) in probe_times.items()
                if key.startswith(prefix)}

    at = "one call at B=128, N=257, bf16"
    variants_build, grouped_build = probe_builds()
    kernels += [
        probe_entry("attn_probe_variants", "attn_probe.cu",
                    "scripts/probe_attn_softmax.py:42", "P1 full", "P1",
                    f"{at}, variant full", variants=rows("P1 "),
                    sass=p1_sass, **variants_build),
        probe_entry("attn_probe_grouped", "attn_probe.cu",
                    "scripts/probe_attn_grouping.py:32", "P2 64 rows, 1 heads",
                    "P2", f"{at}, 64 query rows and 1 head per CTA",
                    geometries=rows("P2 "), sass=p2_sass, **grouped_build),
        probe_entry("ln_matmul", "ln_matmul.cu",
                    "scripts/probe_ln_matmul.py:41", "P3", "P3",
                    "one call at M=32896, K=768, N=2304, bf16",
                    sass=p3_sass, identity=p3_identity,
                    **build_fields("ln_matmul", LN_MATMUL_DESIGN, {
                        "bf16": ("ln_matmul_bf16_tc_kernel",),
                        "f32": ("ln_matmul_f32_kernel",)})),
    ]
    gelu_paths = dict(GELU_LAUNCHES, tp_ranks=tuple(tp[2:4]))
    for i, (d, name) in enumerate((("fwd", "gelu_poly_fwd_kernel"),
                                   ("bwd", "gelu_poly_bwd_kernel"))):
        e = gelu["timed"][f"{d} 128x257x3072"]
        fields = {k: v[d] for k, v in gelu["build"].items() if k != "design"}
        kernels.append(_entry(
            f"gelu_poly_{d}", "gelu_poly.cu", "tpat_tpu/ops/fast_gelu.py:46",
            sum(v[i] for v in gelu_paths.values()), 0.0, e["ms"], e["plain_ms"],
            (e["bound_ms"], "bytes"), e["library_ms"],
            "one call at (128, 257, 3072) bf16", kernel=name,
            shapes={k: v for k, v in gelu["timed"].items()
                    if k.startswith(d)},
            device_ms=e["device_ms"], plain_device_ms=e["plain_device_ms"],
            library_device_ms=e["library_device_ms"],
            step_device_ms=gelu["step"]["device_ms"][name],
            gelu_kernel_share=gelu["step"]["share"],
            design=gelu["build"]["design"], **fields,
            path_launches={k: v[i] for k, v in gelu_paths.items()},
            note="launches: the main paths' own (path_launches), each "
                 "counted from zero over its run, one a block (12 a ViT "
                 "step or bucket forward, 28 an MAE step); phase 25's ranks "
                 "and phase 27's checks and timings are not counted; "
                 "bit-equal to the eager ops (max_abs_err 0); the library "
                 "is F.gelu and aten.gelu_backward (the exact erf GELU), "
                 "which the port does not call on these paths; "
                 "step_device_ms: the kernel's device ms in one traced b128 "
                 "static finetune step (null where the profiler recorded "
                 "no kernel)"))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of phase 25
        dp_rank_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--tp-rank"]:  # a rank of phase 26
        tp_rank_main(sys.argv[2])
    else:
        main()
