"""Training checkpoints and best-checkpoint keeping (``tpat_tpu/utils/
checkpoint.py``), with torch payloads where the JAX package writes orbax.

A checkpoint is one file written by ``torch.save`` (to a temporary name,
then renamed): ``{"model": state dict, "optimizer": state dict, "step":
micro-steps, "epoch": int, "generator": the training generator's state}``,
all on the CPU, so ``--resume`` continues the LR schedule (``step //
accum_iter`` updates), the optimizer moments, drop-path and 2D-masking
draws and the loader epoch.  It loads with ``torch.load(weights_only=True)``.

Under data parallelism only rank 0 writes (the CLIs keep a
``BestCheckpointKeeper`` there and a ``BestScore`` on the other ranks,
which tracks the same score without touching the disk); every rank reads
on resume.

``BestCheckpointKeeper`` follows the reference's best tracking
(``main_finetune.py:548-589``): the best so far in a scratch directory,
saved before the previous best is deleted, and at the end copied to
``output_dir/best_model`` beside a ``best-{epoch:03d}-{score:.4f}.txt``
marker.

Orbax directories written by the JAX package are refused: convert them with
``tpat-convert`` to the reference ``.pth``, which the port reads.
"""

from __future__ import annotations

import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import torch

PAYLOAD_KEYS = ("model", "optimizer", "step", "epoch", "generator")


def _copy(obj, device: Optional[str] = "cpu"):
    """A copy of ``obj`` (nested dicts and lists of an optimizer state dict
    included) with every tensor copied to ``device``, or cloned where it
    lies when ``device`` is None."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.clone() if device is None else t.to(device, copy=True)
    if isinstance(obj, dict):
        return {k: _copy(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_copy(v, device) for v in obj)
    return obj


def state_payload(state, epoch: int, device: Optional[str] = "cpu") -> Dict:
    """The checkpoint payload of an ``engine.train.TrainState``, every
    tensor copied (to ``device``, or where it lies when None) on the
    calling thread, so no later step can change it."""
    return {
        "model": _copy(state.model.state_dict(), device),
        "optimizer": _copy(state.optimizer.state_dict(), device),
        "step": int(state.step),
        "epoch": int(epoch),
        "generator": state.generator.get_state().clone(),
    }


def _write(path: str, payload: Dict):
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


# One background writer, created on first use: a single worker runs the
# asynchronous writes in submission order, so "delete the previous best"
# never races the save it follows.
_WRITER_LOCK = threading.Lock()
_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: list = []


def _writer() -> ThreadPoolExecutor:
    global _WRITER
    with _WRITER_LOCK:
        if _WRITER is None:
            _WRITER = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tpat-ckpt"
            )
        return _WRITER


def _submit(fn, *args) -> Future:
    fut = _writer().submit(fn, *args)
    with _WRITER_LOCK:
        _PENDING.append(fut)
    return fut


def wait_for_checkpoints():
    """Block until every ``background=True`` save has been written, then
    raise the first failure.  Call before reading a checkpoint just written
    and before the process exits."""
    global _PENDING
    with _WRITER_LOCK:
        pending, _PENDING = _PENDING, []
    _join_all(pending)


def _join_all(futures):
    """Wait on every future, then raise the first failure: later writes are
    joined even when an earlier one failed."""
    first = None
    for f in futures:
        try:
            f.result()
        except Exception as e:  # noqa: BLE001 - raised below
            if first is None:
                first = e
    if first is not None:
        raise first


def save_checkpoint(
    path: str, state, epoch: int, *, background: bool = False,
) -> Optional[Future]:
    """Write ``state``'s payload to ``path``.  The payload is copied to host
    memory here; with ``background=True`` only the write runs on the
    background writer, and the Future is returned (``wait_for_checkpoints``
    before the file is read or the process exits)."""
    return save_payload(path, state_payload(state, epoch), background=background)


def save_payload(path: str, payload: Dict, *, background: bool = False
                 ) -> Optional[Future]:
    path = os.path.abspath(path)
    if not background:
        _write(path, payload)
        return None
    return _submit(_write, path, payload)


def refuse_orbax(path: str):
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?): the port reads its own checkpoint files and "
            "reference .pth files; convert an orbax checkpoint with "
            "`tpat-convert --checkpoint <dir> --out <file>.pth`"
        )


def is_payload(obj) -> bool:
    """True for a checkpoint written by this module (a reference ``.pth``
    has no step or generator state)."""
    return isinstance(obj, dict) and all(k in obj for k in PAYLOAD_KEYS)


def restore_checkpoint(path: str) -> Dict:
    """Read a payload written by ``save_checkpoint``."""
    refuse_orbax(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not is_payload(payload):
        raise ValueError(
            f"{path} is not a checkpoint of the port (keys "
            f"{sorted(payload) if isinstance(payload, dict) else type(payload)}"
            f", expected {list(PAYLOAD_KEYS)})"
        )
    return payload


def load_state(state, payload: Dict):
    """Put a payload's model, optimizer, step and generator into ``state``
    (an ``engine.train.TrainState`` of the same configuration)."""
    state.model.load_state_dict(payload["model"], strict=True)
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    state.generator.set_state(payload["generator"])
    state.grad_sum = None


class BestScore:
    """The best score and its epoch by the tie rule, without a file."""

    def __init__(self, ties: str = "last"):
        self.best_score = float("-inf")
        self.best_epoch = -1
        if ties not in ("last", "first"):
            raise ValueError(f"ties must be 'last' or 'first', got {ties!r}")
        self.ties = ties

    def track(self, score: float, epoch: int) -> bool:
        """Update best_score and best_epoch by the tie rule without touching
        disk.  A positive comparison, so a NaN score never becomes (or
        dethrones) the best, as the reference's ``max_score <= score``."""
        improved = score > self.best_score or (
            self.ties == "last" and score == self.best_score
        )
        if not improved:
            return False
        self.best_score = score
        self.best_epoch = epoch
        return True


class BestCheckpointKeeper(BestScore):
    """Keep only the best checkpoint in a scratch directory; ``finalize``
    copies it to the output directory and writes the
    ``best-{epoch:03d}-{score:.4f}.txt`` marker."""

    def __init__(
        self,
        scratch_dir: str,
        output_dir: str,
        ties: str = "last",
        async_save: bool = False,
        snapshot_on_device: bool = False,
    ):
        super().__init__(ties)
        self.scratch_dir = scratch_dir
        self.output_dir = output_dir
        os.makedirs(scratch_dir, exist_ok=True)
        os.makedirs(output_dir, exist_ok=True)
        # async_save runs the write and the prune on the background writer;
        # finalize joins it and raises a failure, after securing the best
        self.async_save = async_save
        self._futures: list = []
        # snapshot_on_device keeps the best payload as a device copy and
        # writes it once, in finalize: no device-to-host copy per improving
        # epoch, at the price of one more copy of the state in device
        # memory; a crash before finalize loses the best
        self.snapshot_on_device = snapshot_on_device
        self._snapshot: Optional[Dict] = None

    def _path(self, epoch: int) -> str:
        return os.path.join(self.scratch_dir, f"checkpoint-{epoch:03d}")

    def update(self, score: float, state, epoch: int) -> bool:
        """Ties: AudioMAE keeps the LAST epoch reaching the best score
        (``main_finetune.py:548``), AST the FIRST (``traintest.py:236-247``):
        choose with ``ties``.  The new checkpoint is saved before the old
        one is deleted, so a failed save loses neither; a scratch directory
        needs room for two."""
        prev = (self.best_score, self.best_epoch)
        if not self.track(score, epoch):
            return False
        if self.snapshot_on_device:
            self._snapshot = state_payload(state, epoch, device=None)
            return True
        new_path = self._path(epoch)
        new_name = os.path.basename(new_path)

        def prune(save_fut: Optional[Future] = None):
            if save_fut is not None and save_fut.exception() is not None:
                # roll best tracking back, unless a newer best has already
                # superseded this epoch: otherwise a later, lower score that
                # beats what is on disk would never be saved
                if (self.best_score, self.best_epoch) == (score, epoch):
                    self.best_score, self.best_epoch = prev
                print(
                    f"[checkpoint] WARNING: async save of {new_name} "
                    f"failed ({save_fut.exception()!r}); best tracking "
                    f"rolled back to epoch {self.best_epoch}",
                    flush=True,
                )
                return
            for old in os.listdir(self.scratch_dir):
                if old.startswith("checkpoint-") and old != new_name:
                    os.remove(os.path.join(self.scratch_dir, old))

        if self.async_save:
            # the payload is copied to host memory here, on the caller's
            # thread; the writer only writes it
            save_fut = save_checkpoint(new_path, state, epoch, background=True)
            self._futures += [save_fut, _submit(prune, save_fut)]
        else:
            save_checkpoint(new_path, state, epoch)
            prune()
        return True

    def finalize(self) -> Optional[str]:
        """Join the writes, copy the best to ``output_dir/best_model`` and
        write the marker, then raise the first failed write, if any: a
        failed save was rolled back by its prune, so best_epoch names a
        checkpoint that was written.  Returns the best_model path."""
        if self._snapshot is not None:
            snap = self._snapshot
            save_payload(self._path(snap["epoch"]), _copy(snap))
            self._snapshot = None
        pending, self._futures = self._futures, []
        errors = []
        for f in pending:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 - raised below
                errors.append(e)
        dst = None
        if self.best_epoch >= 0:
            marker = os.path.join(
                self.output_dir,
                f"best-{self.best_epoch:03d}-{self.best_score:.4f}.txt",
            )
            open(marker, "w").close()
            dst = os.path.join(self.output_dir, "best_model")
            shutil.copyfile(self._path(self.best_epoch), dst)
            for old in os.listdir(self.scratch_dir):
                if old.startswith("checkpoint-"):
                    os.remove(os.path.join(self.scratch_dir, old))
        if errors:
            raise errors[0]
        return dst
