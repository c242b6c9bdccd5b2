"""Evaluation loops (``tpat_tpu/engine/evaluate.py``): single-label acc1,
acc5 and CE loss, and multilabel mAP.

The eval forward is the static ``AudioViT.__call__`` in eval mode under
``torch.no_grad()``, so it runs the attention forward kernel (B1) on the
card.  A ragged last batch is padded to the batch size with copies of its
last row and the padding trimmed from the logits, as the JAX engine pads
to its compiled shape; the port needs no fixed shape, but keeps the
padding so the forward sees the same batches.  Batches come as numpy
arrays (the host loader) or as tensors already on the device (the device
dataset cache, ``data/device_cache.py``): those are used where they lie,
padded there, and only their labels are read back.  Logits are fetched one
batch behind, so the device computes batch b while the host collects b-1.

The ablations run as in JAX: ``custom_rank`` through the static forward;
the intensity band through ``forward_masked`` with host-double kept-count
tables, which returns each sample's kept count, and a sample the band
emptied is left out of the metrics.

``preprocess`` (the device frontend) runs at the head of every eval
forward with ``specaug=False, train=False``, so the ``mel`` feature that
``feature_writer`` (``utils.features.FeatureWriter``, or any callback)
saves is the frontend's output.

``allgather=True`` (``--dist_eval`` over several processes): each rank
scores its own unpadded shard, and the logits and targets of every rank are
gathered (``allgather_rows``) before the accuracies or the mAP, which are
then exact over the whole set; the reported CE loss stays the rank's own
mean of per-batch means, as in JAX (the reference never gathers it).  No
collective runs per batch, so the JAX CLI's ``n_valid=0`` filler batches
have no counterpart.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from tpat_tpu_torch.engine import metrics as metrics_lib
from tpat_tpu_torch.engine import schedules
from tpat_tpu_torch.models.vit import AudioViT
from tpat_tpu_torch.parallel import distributed as dist_lib


def allgather_rows(arr: np.ndarray) -> np.ndarray:
    """Every rank's row block, concatenated in rank order (the
    ``concat_all_gather`` of ``util/misc.py:350-361`` without its
    equal-shape restriction): the row counts are gathered first, the ragged
    blocks padded to the largest, gathered, then trimmed.  Host arrays over
    the gloo group, which has no ``all_gather`` for CUDA tensors.  Without
    a process group, ``arr`` itself."""
    _, world = dist_lib.group_rank_world()
    if world == 1:
        return arr
    counts = [int(c[0]) for c in dist_lib.all_gather_host(
        np.asarray([arr.shape[0]], np.int64))]
    m = max(counts)
    if arr.shape[0] < m:
        pad = np.zeros((m - arr.shape[0],) + arr.shape[1:], arr.dtype)
        arr = np.concatenate([arr, pad])
    blocks = dist_lib.all_gather_host(arr)
    return np.concatenate([b[:c] for b, c in zip(blocks, counts)])


def make_eval_step(
    model: AudioViT,
    extract_features: bool = False,
    custom_rank=None,
    intensity_band=None,
    preprocess=None,
) -> Callable[[torch.Tensor], object]:
    """The eval forward: logits, or (logits, features) with
    ``extract_features``, or (logits, kept counts) with ``intensity_band``
    = (retain_min, retain_max, block), which combines with neither
    features nor ``custom_rank`` (``evaluate.py:72-110``)."""

    def pre(x: torch.Tensor) -> torch.Tensor:
        if preprocess is None:
            return x
        return preprocess(x, None, specaug=False, train=False)

    if intensity_band is not None:
        if extract_features or custom_rank is not None:
            raise ValueError(
                "intensity_band cannot be combined with feature "
                "extraction or custom_rank"
            )
        cfg = model.cfg
        tables = torch.from_numpy(schedules.kept_count_tables(
            cfg.keep_rates, cfg.drop_loc, cfg.num_patches))

        def band_step(x: torch.Tensor):
            model.eval()
            with torch.no_grad():
                return model.forward_masked(
                    pre(x), cfg.keep_rates, num_left_tables=tables.to(x.device),
                    intensity_band=tuple(intensity_band))

        return band_step

    def step(x: torch.Tensor):
        model.eval()
        with torch.no_grad():
            return model(pre(x), extract_features=extract_features,
                         custom_rank=custom_rank)

    return step


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _labels(y) -> np.ndarray:
    """A batch's targets as numpy, from the host loader or the device."""
    return _host(y) if isinstance(y, torch.Tensor) else np.asarray(y)


def _run_batches(
    eval_step,
    batches: Iterable,
    batch_size: int,
    device,
    feature_writer: Optional[Callable[[Dict, int], None]] = None,
    index_to_name: Optional[Dict[int, str]] = None,
    band_mode: bool = False,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """``batches`` yields (x, y) or (x, y, n_valid), numpy or tensors; rows
    past n_valid are padding.  In ``band_mode`` the step returns (logits,
    kept counts) and the samples with nothing kept are skipped.  Returns
    (logits, targets, rows per batch)."""
    all_logits, all_targets = [], []
    pending = None

    def _consume(out, n, y, bidx):
        if band_mode:
            logits, kept = out
            keep = _host(kept[:n]) > 0
            all_logits.append(_host(logits[:n])[keep])
            all_targets.append(_labels(y)[:n][keep])
            return
        if feature_writer is not None:
            logits, features = out
            features = {k: _host(v[:n]) for k, v in features.items()}
            # trim before the argmax: rows past n are padding
            y_n = _labels(y)[:n]
            features["labels"] = (
                [index_to_name[int(i)] for i in np.argmax(y_n, axis=1)]
                if index_to_name is not None else ["temp"] * n
            )
            feature_writer(features, bidx)
        else:
            logits = out
        all_logits.append(_host(logits[:n]))
        all_targets.append(_labels(y)[:n])

    for bidx, item in enumerate(batches):
        x, y = item[0], item[1]
        n = item[2] if len(item) > 2 else x.shape[0]
        x = torch.as_tensor(x, device=device)
        if x.shape[0] < batch_size:
            pad = batch_size - x.shape[0]
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        out = eval_step(x)
        if pending is not None:
            _consume(*pending)
        pending = (out, n, y, bidx)
    if pending is not None:
        _consume(*pending)
    sizes = [len(a) for a in all_logits]
    return np.concatenate(all_logits), np.concatenate(all_targets), sizes


def evaluate_classification(
    model: AudioViT,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    device=None,
    feature_writer=None,
    index_to_name=None,
    custom_rank=None,
    intensity_band=None,
    preprocess=None,
    allgather: bool = False,
) -> Dict[str, float]:
    """Single-label eval: acc1, acc5 and the CE loss on argmax targets.
    ``device`` defaults to the model's.  ``allgather``: the accuracies over
    every rank's rows (``allgather_rows``), the loss over this rank's."""
    device = device or next(model.parameters()).device
    step = make_eval_step(model, extract_features=feature_writer is not None,
                          custom_rank=custom_rank,
                          intensity_band=intensity_band, preprocess=preprocess)
    logits, targets, sizes = _run_batches(
        step, batches, batch_size, device, feature_writer, index_to_name,
        band_mode=intensity_band is not None,
    )
    tgt_idx = np.argmax(targets, axis=1)
    if allgather:
        acc1, acc5 = metrics_lib.topk_accuracy(
            allgather_rows(logits), np.argmax(allgather_rows(targets), axis=1),
            ks=(1, 5))
    else:
        acc1, acc5 = metrics_lib.topk_accuracy(logits, tgt_idx, ks=(1, 5))
    logp = torch.log_softmax(torch.from_numpy(logits), dim=-1).numpy()
    # the reference's reported loss is an UNWEIGHTED mean of per-batch CE
    # means (metric_logger.update(loss=...) with n=1,
    # engine_finetune.py:194): a ragged last batch weighs as much as a full
    # one
    per_batch, off = [], 0
    for s in sizes:
        if s == 0:
            continue
        idx = np.arange(off, off + s)
        per_batch.append(float(-np.mean(logp[idx, tgt_idx[idx]])))
        off += s
    loss = float(np.mean(per_batch)) if per_batch else 0.0
    return {"acc1": float(acc1), "acc5": float(acc5), "loss": loss}


def evaluate_multilabel(
    model: AudioViT,
    batches: Iterable[Tuple[np.ndarray, np.ndarray]],
    batch_size: int,
    device=None,
    feature_writer=None,
    preprocess=None,
    allgather: bool = False,
    custom_rank=None,
    intensity_band=None,
) -> Dict[str, float]:
    """Multilabel eval: the mean over classes of the average precision.
    The JAX function takes no ablation; ``cli/run_ast.py --eval`` passes
    both, so here they run as in ``evaluate_classification``.
    ``allgather``: the mAP over every rank's rows (``allgather_rows``)."""
    device = device or next(model.parameters()).device
    step = make_eval_step(model, extract_features=feature_writer is not None,
                          custom_rank=custom_rank,
                          intensity_band=intensity_band, preprocess=preprocess)
    logits, targets, _sizes = _run_batches(
        step, batches, batch_size, device, feature_writer,
        band_mode=intensity_band is not None,
    )
    if allgather:
        logits, targets = allgather_rows(logits), allgather_rows(targets)
    return {"mAP": metrics_lib.mean_average_precision(logits, targets)}
