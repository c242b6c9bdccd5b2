"""The port's checkpoints (utils/checkpoint.py): torch payloads in place of
the JAX package's orbax ones, with its BestCheckpointKeeper rules (ties,
NaN, save before prune, rollback of a failed async save, the device
snapshot) and a resume that continues training bit for bit.  Mirrors the
checkpoint tests of tests/test_train_engine.py and
tests/test_cli_e2e.py::test_keeper_tie_semantics, on the CPU."""

import os
import threading

import numpy as np
import pytest
import torch

from tpat_tpu_torch.config import TrainConfig, ViTConfig
from tpat_tpu_torch.engine.train import TrainModule
from tpat_tpu_torch.utils import checkpoint as ckpt_lib


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The tiny models run thousands of small torch ops; beside the other
    test workers, intra-op threads only contend (this file took minutes
    with all threads in a parallel run, seconds alone), so one thread for
    this module, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _module(epochs=3):
    cfg = ViTConfig(compute_dtype="float32", embed_dim=32, depth=2, num_heads=2,
                    num_classes=3, target_length=32, num_mel_bins=32,
                    drop_loc=(1,), base_keep_rate=0.5, drop_path_rate=0.2)
    tc = TrainConfig(batch_size=4, epochs=epochs, warmup_epochs=1,
                     base_keep_rate=0.5, drop_loc=(1,), shrink_start_epoch=1,
                     shrink_epochs=1, mask_t_prob=0.3, mask_f_prob=0.3)
    return TrainModule(cfg, tc, "ce", iters_per_epoch=2, device="cpu")


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 1, 32, 32)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=4)])
            for _ in range(2)]


def _same_state(a, b):
    for (k, v), (k2, w) in zip(a.model.state_dict().items(),
                               b.model.state_dict().items()):
        assert k == k2 and torch.equal(v, w), k
    assert a.step == b.step
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _markers(out):
    return sorted(p for p in os.listdir(out) if p.startswith("best-"))


def test_keeper_tie_semantics(tmp_path):
    """AudioMAE keeps the LAST epoch on ties, AST the FIRST; track() updates
    without writing; a NaN never becomes (or dethrones) the best."""
    state = _module().init()
    last = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "a"), str(tmp_path / "b"))
    for ep, sc in [(1, 0.5), (2, 0.5), (3, 0.4)]:
        last.update(sc, state, ep)
    assert last.best_epoch == 2
    first = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "c"), str(tmp_path / "d"),
                                          ties="first")
    for ep, sc in [(1, 0.5), (2, 0.5), (3, 0.4)]:
        first.update(sc, state, ep)
    assert first.best_epoch == 1
    tracker = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "e"), str(tmp_path / "f"))
    for ep, sc in [(1, 0.5), (2, 0.5), (3, 0.4)]:
        tracker.track(sc, ep)
    assert (tracker.best_score, tracker.best_epoch) == (last.best_score, last.best_epoch)
    assert os.listdir(tmp_path / "e") == []
    nan = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "g"), str(tmp_path / "h"))
    for ep, sc in [(1, 0.9), (2, float("nan")), (3, 0.3)]:
        nan.update(sc, state, ep)
    assert (nan.best_score, nan.best_epoch) == (0.9, 1)
    assert os.listdir(tmp_path / "g") == ["checkpoint-001"]
    with pytest.raises(ValueError, match="ties"):
        ckpt_lib.BestCheckpointKeeper(str(tmp_path / "i"), str(tmp_path / "j"),
                                      ties="middle")


def test_checkpoint_roundtrip_resumes_bit_for_bit(tmp_path):
    """Save after epoch 0, restore into a fresh state from another seed, and
    the next two epochs (anneal, static; drop-path and 2D masking draw from
    the generator) give the same losses, weights, optimizer moments, step
    and generator as the run that never stopped; the keeper's best_model
    and marker follow the tie rule."""
    mod, batches = _module(), _batches()
    state = mod.init(seed=1)
    state, _ = mod.train_epoch(state, batches, 0)
    path = str(tmp_path / "ckpt")
    assert ckpt_lib.save_checkpoint(path, state, 0) is None
    straight = [mod.train_epoch(state, batches, e)[1] for e in (1, 2)]

    other = mod.init(seed=2)
    payload = ckpt_lib.restore_checkpoint(path)
    assert payload["epoch"] == 0 and payload["step"] == 2
    ckpt_lib.load_state(other, payload)
    resumed = [mod.train_epoch(other, batches, e)[1] for e in (1, 2)]
    assert resumed == straight
    _same_state(state, other)
    opt_a, opt_b = state.optimizer.state_dict(), other.optimizer.state_dict()
    for i, s in opt_a["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt_b["state"][i][k]), (i, k)

    keeper = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "scratch"),
                                           str(tmp_path / "out"))
    assert keeper.update(0.5, state, epoch=0)
    assert not keeper.update(0.3, state, epoch=1)
    assert keeper.update(0.5, state, epoch=2)
    best = keeper.finalize()
    assert best == str(tmp_path / "out" / "best_model")
    assert _markers(tmp_path / "out") == ["best-002-0.5000.txt"]
    assert ckpt_lib.restore_checkpoint(best)["epoch"] == 2
    assert os.listdir(tmp_path / "scratch") == []


def test_checkpoint_async_matches_sync(tmp_path):
    """The background writer gives the sync path's payload, prunes the
    scratch directory to the best, and writes what the state was when
    update() returned: the payload is copied on the caller's thread (the
    writer is held back here until the state has changed)."""
    mod = _module()
    state = mod.init()
    sync = str(tmp_path / "sync")
    ckpt_lib.save_checkpoint(sync, state, 7)
    keeper = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "scratch"),
                                           str(tmp_path / "out"), async_save=True)
    assert keeper.update(0.5, state, epoch=0)
    assert not keeper.update(0.3, state, epoch=1)
    gate = threading.Event()
    ckpt_lib._submit(gate.wait, 10.0)
    assert keeper.update(0.7, state, epoch=7)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    state.step += 5
    gate.set()
    ckpt_lib.wait_for_checkpoints()
    assert os.listdir(tmp_path / "scratch") == ["checkpoint-007"]
    best = keeper.finalize()
    assert _markers(tmp_path / "out") == ["best-007-0.7000.txt"]
    got, want = ckpt_lib.restore_checkpoint(best), ckpt_lib.restore_checkpoint(sync)
    assert (got["epoch"], got["step"]) == (want["epoch"], want["step"]) == (7, 0)
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    assert torch.equal(got["generator"], want["generator"])
    assert got["optimizer"]["param_groups"] == want["optimizer"]["param_groups"]


def test_checkpoint_best_on_device_snapshot(tmp_path):
    """snapshot_on_device keeps a copy of the best and writes it only in
    finalize; a tie replaces it; later changes to the live state do not
    reach it."""
    mod, batches = _module(), _batches()
    state = mod.init()
    keeper = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "scratch"),
                                           str(tmp_path / "out"),
                                           snapshot_on_device=True)
    assert keeper.update(0.5, state, epoch=0)
    state, _ = mod.train_epoch(state, batches, 0)
    cls = state.model.cls_token.detach().clone()
    assert keeper.update(0.5, state, epoch=1)
    assert not keeper.update(0.3, state, epoch=2)
    assert os.listdir(tmp_path / "scratch") == []
    state, _ = mod.train_epoch(state, batches, 1)
    assert not torch.equal(state.model.cls_token, cls)
    best = keeper.finalize()
    assert _markers(tmp_path / "out") == ["best-001-0.5000.txt"]
    restored = ckpt_lib.restore_checkpoint(best)
    assert restored["epoch"] == 1 and restored["step"] == 2
    assert torch.equal(restored["model"]["cls_token"], cls)
    assert os.listdir(tmp_path / "scratch") == []


def test_checkpoint_async_failed_save_keeps_previous_best(tmp_path, monkeypatch):
    """A failed async save deletes nothing, rolls best tracking back so a
    later lower score still saves, and finalize raises it only after
    securing the best that was written."""
    state = _module().init()
    keeper = ckpt_lib.BestCheckpointKeeper(str(tmp_path / "scratch"),
                                           str(tmp_path / "out"), async_save=True)
    assert keeper.update(0.5, state, epoch=0)
    ckpt_lib.wait_for_checkpoints()
    real = ckpt_lib._write

    def disk_full(path, payload):
        raise OSError("scratch ramdisk full")

    monkeypatch.setattr(ckpt_lib, "_write", disk_full)
    assert keeper.update(0.7, state, epoch=2)
    with pytest.raises(OSError, match="ramdisk full"):
        ckpt_lib.wait_for_checkpoints()
    assert os.listdir(tmp_path / "scratch") == ["checkpoint-000"]
    assert (keeper.best_score, keeper.best_epoch) == (0.5, 0)
    monkeypatch.setattr(ckpt_lib, "_write", real)
    assert keeper.update(0.6, state, epoch=3)
    with pytest.raises(OSError, match="ramdisk full"):
        keeper.finalize()
    assert _markers(tmp_path / "out") == ["best-003-0.6000.txt"]
    assert ckpt_lib.restore_checkpoint(str(tmp_path / "out" / "best_model"))["epoch"] == 3


def test_restore_refuses_orbax_and_foreign_files(tmp_path):
    """An orbax directory points to tpat-convert; a file that is not the
    port's payload (a reference .pth) is refused by restore."""
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="tpat-convert"):
        ckpt_lib.restore_checkpoint(str(tmp_path / "orbax"))
    torch.save({"model": {"cls_token": torch.zeros(1)}}, tmp_path / "ref.pth")
    with pytest.raises(ValueError, match="not a checkpoint of the port"):
        ckpt_lib.restore_checkpoint(str(tmp_path / "ref.pth"))
