"""Data parallelism of the port (``tpat_tpu_torch/parallel``) on the CPU,
over gloo, in ranks spawned from this file (``python
tests/test_torch_distributed.py <task> <dir>``), mirroring
``tests/test_multihost.py``.

One spawn of two ranks (torchrun's variables) runs, on each rank:

- the tiny ViT of ``test_multihost.py`` over its ``EpochShardSampler(world=2,
  rank)`` shard for three epochs (dense, anneal, static), then the
  gathered ``--dist_eval``-style eval; the parent holds the losses to JAX's
  single-process ``TrainModule`` over the same global batches (rtol 2e-4)
  and the gathered acc1 to JAX's full-set eval;
- the same run with drop-path and 2D masking on, held to the port's own
  one-process run of the global batches (1e-5): the global-draw rule;
- two MAE pretrain steps on its half of a global batch, held to one
  process over the whole batch;
- ``cli.finetune`` (``--dist_eval``), ``cli.run_ast`` and ``cli.pretrain``
  on the tone corpus, with every write of each rank under the output
  directories recorded by an audit hook: equal parameters on both ranks,
  rank-0-only artifacts, and the gathered eval equal to a one-process
  ``--eval`` of the kept model.

A spawn of three ranks (the JAX package's variables) holds
``allgather_rows`` on ragged blocks (5/4/4 rows) to the numpy
concatenation.  The layout, backend and device rules and the eval shards
are tested as pure functions.  Each spawn runs with one thread per rank
and a time limit, so a hang fails instead of stalling the suite.
"""

import hashlib
import json
import math
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, B_HOST, CLASSES = 16, 4, 4
SPAWN_TIMEOUT = 300  # seconds a spawn of ranks may take
MAE_SMALL = dict(
    embed_dim=96, depth=2, num_heads=3, decoder_embed_dim=128,
    decoder_depth=2, decoder_num_heads=4, decoder_mode=1, num_mel_bins=128,
    window_size=(4, 4), compute_dtype="float32", target_length=64,
    mask_2d=True, norm_pix_loss=True,
)
MAE_BATCH, MAE_STEPS, MAE_RATIO = 4, 2, 0.8
LAUNCH_VARS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "RANK",
               "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
               "MASTER_PORT", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
               "SLURM_NTASKS_PER_NODE", "SLURM_JOB_ID")


# -- shared by the parent and the ranks -----------------------------------

def _dataset():
    rng = np.random.default_rng(42)
    y_idx = rng.integers(0, CLASSES, size=N)
    x = rng.normal(size=(N, 1, 64, 32)).astype(np.float32)
    x[np.arange(N), 0, 0, 0] = y_idx * 2.0
    return x, np.eye(CLASSES, dtype=np.float32)[y_idx]


def _vit_kw(**kw):
    return {**dict(compute_dtype="float32", embed_dim=64, depth=3, num_heads=2,
                   num_classes=CLASSES, target_length=64, num_mel_bins=32,
                   drop_loc=(1,), base_keep_rate=0.6, drop_path_rate=0.0),
            **kw}


def _tc_kw(batch, hosts, **kw):
    return dict(batch_size=batch, epochs=4, blr=2e-3, warmup_epochs=1,
                shrink_start_epoch=1, shrink_epochs=1, base_keep_rate=0.6,
                drop_loc=(1,), num_hosts=hosts, **kw)


def _global_batches(X, Y, epoch, world=2):
    """The global batches the ranks' shards make, built as
    ``test_multihost.py`` builds them: rank r's rows after rank r-1's."""
    from tpat_tpu_torch.data.sampler import EpochShardSampler

    shards = []
    for r in range(world):
        s = EpochShardSampler(N, shuffle=True, seed=3, world=world, rank=r)
        s.set_epoch(epoch)
        shards.append(np.asarray(s.indices()))
    iters = len(shards[0]) // B_HOST
    out = []
    for i in range(0, iters * B_HOST, B_HOST):
        rows = np.concatenate([sh[i:i + B_HOST] for sh in shards])
        out.append((X[rows], Y[rows]))
    return out


def _train(sd, batch, hosts, epochs_batches, stochastic):
    """The port's TrainModule from ``sd`` over each epoch's batches:
    per-epoch losses and grad norms, and the final state."""
    from tpat_tpu_torch.config import TrainConfig, ViTConfig
    from tpat_tpu_torch.engine.train import TrainModule

    extra = dict(mask_t_prob=0.2, mask_f_prob=0.2) if stochastic else {}
    cfg = ViTConfig(**_vit_kw(drop_path_rate=0.1 if stochastic else 0.0))
    mod = TrainModule(cfg, TrainConfig(**_tc_kw(batch, hosts, **extra)), "ce",
                      iters_per_epoch=len(epochs_batches[0]), device="cpu")
    state = mod.load(sd, seed=5)
    losses, norms = [], []
    for epoch, batches in enumerate(epochs_batches):
        state, stats = mod.train_epoch(state, batches, epoch)
        losses.append(stats["loss"])
        norms.append(stats["grad_norm"])
    return losses, norms, state


def _mae_model():
    from tpat_tpu_torch.models import mae

    return mae.MaskedAutoencoderViT(
        mae.MAEConfig(**MAE_SMALL), generator=torch.Generator().manual_seed(3))


def _mae_steps(x_rows, steps=MAE_STEPS):
    """``MAE_STEPS`` pretrain steps on ``x_rows``: the losses and the final
    state dict."""
    from tpat_tpu_torch.engine import pretrain

    model = _mae_model()
    opt = pretrain.make_mae_optimizer(model, weight_decay=0.05,
                                      pos_trainable=False)
    step = pretrain.make_mae_train_step(model, opt, MAE_RATIO,
                                        lambda s: 1e-3, seed=7)
    losses = []
    for i in range(steps):
        losses.append(step(torch.zeros(()), i, torch.from_numpy(x_rows)).item())
    return losses, {k: v.clone() for k, v in model.state_dict().items()}


def _mae_batch():
    rng = np.random.default_rng(9)
    return rng.normal(size=(MAE_BATCH, 1, MAE_SMALL["target_length"],
                            MAE_SMALL["num_mel_bins"])).astype(np.float32)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _write_corpus(root):
    """16 train and 8 eval tone clips of 1 s, 4 classes (the CLI tests'
    corpus)."""
    from tpat_tpu_torch.data.wav import save_wav

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(0)
    entries = {"tr": [], "ev": []}
    for split, n in (("tr", 16), ("ev", 8)):
        for i in range(n):
            cls = i % 4
            t = np.arange(16000) / 16000
            w = 0.4 * np.sin(2 * math.pi * (300 + 200 * cls) * t)
            w += 0.02 * rng.normal(size=t.size)
            path = os.path.join(root, f"{split}{i}.wav")
            save_wav(path, w.astype(np.float32), 16000)
            entries[split].append({"wav": path, "labels": f"/m/{cls:02d}"})
    for split, name in (("tr", "train"), ("ev", "eval")):
        with open(os.path.join(root, f"{name}.json"), "w") as f:
            json.dump({"data": entries[split]}, f)
    with open(os.path.join(root, "labels.csv"), "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(4):
            f.write(f'{c},/m/{c:02d},"tone {c}"\n')


def _finetune_argv(corpus, out, *extra):
    return ["--dataset", "esc50", "--model", "audiomae_vit_tiny",
            "--target_length", "128",
            "--data_train", os.path.join(corpus, "train.json"),
            "--data_eval", os.path.join(corpus, "eval.json"),
            "--label_csv", os.path.join(corpus, "labels.csv"),
            "--nb_classes", "4", "--batch_size", "4", "--blr", "2e-3",
            "--warmup_epochs", "1", "--base_keep_rate", "0.6",
            "--drop_loc", "(1, 3)", "--epochs", "2", "--shrink_start_epoch",
            "1", "--shrink_epochs", "0", "--mask_t_prob", "0.2",
            "--mask_f_prob", "0.2", "--compute_dtype", "float32",
            "--output_dir", out, "--num_workers", "1", *extra]


def _ast_argv(corpus, exp):
    return ["--dataset", "esc50", "--model_size", "tiny_debug",
            "--data-train", os.path.join(corpus, "train.json"),
            "--data-val", os.path.join(corpus, "eval.json"),
            "--label-csv", os.path.join(corpus, "labels.csv"),
            "--n_class", "4", "-b", "4", "--audio_length", "128",
            "--metrics", "acc", "--loss", "CE", "--drop_loc", "(1, 3)",
            "--base_keep_rate", "0.6", "--n-epochs", "1",
            "--imagenet_pretrain", "False", "--exp-dir", exp, "-w", "1"]


def _pretrain_argv(corpus, out):
    return ["--dataset", "esc50", "--model", "mae_vit_tiny",
            "--target_length", "128",
            "--data_train", os.path.join(corpus, "train.json"),
            "--label_csv", os.path.join(corpus, "labels.csv"),
            "--batch_size", "4", "--warmup_epochs", "1", "--epochs", "1",
            "--num_workers", "1", "--output_dir", out]


# -- the ranks -------------------------------------------------------------

def _audit_writes(prefixes, log):
    """Record every write-mode open, directory made, rename, removal and
    file copy under ``prefixes`` (an audit hook: numpy's, torch's and the
    CLIs' own writes all pass through these events)."""
    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
            paths = [path] if writes else []
        elif event in ("os.mkdir", "os.rmdir", "os.remove", "shutil.copyfile"):
            paths = [args[0]] if event != "shutil.copyfile" else [args[1]]
        elif event == "os.rename":
            paths = [args[1]]
        else:
            return
        for p in paths:
            p = os.fspath(p) if isinstance(p, (str, os.PathLike)) else ""
            if any(p.startswith(pre) for pre in prefixes):
                log.append(f"{event} {p}")

    sys.addaudithook(hook)


def _rank_engine(rank, world, out):
    X, Y = _dataset()
    from tpat_tpu_torch.data.sampler import EpochShardSampler, eval_shard
    from tpat_tpu_torch.engine import evaluate

    sd = torch.load(os.path.join(out, "init.pt"))
    sampler = EpochShardSampler(N, shuffle=True, seed=3, world=world, rank=rank)
    iters = len(sampler) // B_HOST
    epochs = []
    for epoch in range(3):
        sampler.set_epoch(epoch)
        idx = np.asarray(sampler.indices())
        epochs.append([(X[idx[i:i + B_HOST]], Y[idx[i:i + B_HOST]])
                       for i in range(0, iters * B_HOST, B_HOST)])
    res = {}
    for stochastic in (False, True):
        losses, norms, state = _train(sd, B_HOST, world, epochs, stochastic)
        key = "stochastic" if stochastic else "plain"
        res[key] = {"losses": losses, "grad_norms": norms,
                    "digest": _digest(state.params)}
        if rank == 0:
            torch.save(state.model.state_dict(),
                       os.path.join(out, f"final_{key}.pt"))
        if not stochastic:
            rows = eval_shard(N, world, rank)
            batches = [(X[rows[i:i + B_HOST]], Y[rows[i:i + B_HOST]])
                       for i in range(0, len(rows), B_HOST)]
            res["acc1"] = evaluate.evaluate_classification(
                state.model, batches, B_HOST, allgather=True)["acc1"]
    x = _mae_batch()
    half = MAE_BATCH // world
    losses, mae_sd = _mae_steps(x[rank * half:(rank + 1) * half])
    res["mae"] = {"losses": losses, "digest": _digest(mae_sd.values())}
    if rank == 0:
        torch.save(mae_sd, os.path.join(out, "final_mae.pt"))
    return res


def _rank_clis(rank, out):
    from tpat_tpu_torch.cli import finetune, pretrain, run_ast
    from tpat_tpu_torch.engine import pretrain as pretrain_lib
    from tpat_tpu_torch.engine import train as train_lib

    corpus = os.path.join(out, "corpus")
    outs = {k: os.path.join(out, k) for k in ("ft", "ast", "pt")}
    writes = []
    _audit_writes(tuple(outs.values()), writes)
    final = {}
    train_epoch = train_lib.TrainModule.train_epoch

    def keep_last(self, state, *a, **kw):
        state, stats = train_epoch(self, state, *a, **kw)
        final["params"] = state.params
        return state, stats

    train_lib.TrainModule.train_epoch = keep_last
    make_step = pretrain_lib.make_mae_train_step

    def keep_model(model, *a, **kw):
        final["params"] = list(model.parameters())
        return make_step(model, *a, **kw)

    pretrain_lib.make_mae_train_step = keep_model
    res = {}
    sys.modules["torch.utils.tensorboard"] = None  # no TensorBoard writer
    best = finetune.main(finetune.get_args_parser().parse_args(
        _finetune_argv(corpus, outs["ft"], "--dist_eval")), device="cpu")
    res["ft"] = {"best": best, "digest": _digest(final["params"])}
    best = run_ast.main(run_ast.get_parser().parse_args(
        _ast_argv(corpus, outs["ast"])), device="cpu")
    res["ast"] = {"best": best, "digest": _digest(final["params"])}
    losses = pretrain.main(pretrain.get_args_parser().parse_args(
        _pretrain_argv(corpus, outs["pt"])), device="cpu")
    res["pt"] = {"losses": losses, "digest": _digest(final["params"])}
    res["writes"] = writes
    return res


def _rank_gather(rank, world):
    from tpat_tpu_torch.engine.evaluate import allgather_rows
    from tpat_tpu_torch.parallel import distributed as dist_lib

    rows = (5, 4, 4)[rank]
    start = sum((5, 4, 4)[:rank])
    block = np.arange(start * 3, (start + rows) * 3, dtype=np.float32)
    g = allgather_rows(block.reshape(rows, 3))
    dist_lib.check_equal(7, "a constant")
    err = None
    try:
        dist_lib.check_equal(rank, "the rank")
    except RuntimeError as e:
        err = str(e)
    obj = dist_lib.broadcast_object({"from": rank} if rank == 0 else None)
    return {"gathered": g.tolist(), "check_error": err, "object": obj}


def _rank_main(task, out):
    torch.set_num_threads(1)
    from tpat_tpu_torch.parallel import distributed as dist_lib

    rank, world, device = dist_lib.init_distributed_mode("cpu", timeout=120)
    assert device == torch.device("cpu")
    if task == "gather":
        res = _rank_gather(rank, world)
    else:
        res = {"engine": _rank_engine(rank, world, out),
               "cli": _rank_clis(rank, out)}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist_lib.leave()


# -- the parent ------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(task, world, out, jax_names=False):
    """Start ``world`` ranks of ``task``; returns their Popen objects."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = _free_port()
    procs = []
    for rank in range(world):
        if jax_names:
            names = {"COORDINATOR_ADDRESS": f"localhost:{port}",
                     "NUM_PROCESSES": str(world), "PROCESS_ID": str(rank)}
        else:
            names = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                     "WORLD_SIZE": str(world), "RANK": str(rank),
                     "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(out)],
            env={**env, **names}, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def _wait(procs, out):
    """Each rank's result; a rank that fails or outlives SPAWN_TIMEOUT fails
    the test (every rank is killed first)."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return [json.load(open(os.path.join(out, f"rank{r}.json")))
            for r in range(len(procs))], logs


def _jax_init():
    """JAX's single-process TrainModule (as ``test_multihost.py``), its
    initial state and those weights as a port state dict."""
    import jax

    from tpat_tpu.config import TrainConfig, ViTConfig
    from tpat_tpu.engine.train import TrainModule
    from tpat_tpu.models.vit import AudioViT
    from tpat_tpu_torch.utils.weights import state_dict_from_jax

    cfg = ViTConfig(attention_impl="xla", **_vit_kw())
    mod = TrainModule(model=AudioViT(cfg), model_cfg=cfg,
                      train_cfg=TrainConfig(**_tc_kw(2 * B_HOST, 1)),
                      loss_type="ce", iters_per_epoch=2)
    state = mod.init(np.zeros((1, 1, 64, 32), np.float32), seed=11)
    return mod, state, state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params))


def _jax_reference(mod, state, X, Y):
    """The JAX module over the global batches: per-epoch losses and the
    full-set eval's acc1."""
    from tpat_tpu.engine import evaluate as eval_lib

    losses = []
    for epoch in range(3):
        state, stats = mod.train_epoch(state, _global_batches(X, Y, epoch),
                                       epoch)
        losses.append(stats["loss"])
    ebatches = ((X[i:i + 2 * B_HOST], Y[i:i + 2 * B_HOST])
                for i in range(0, N, 2 * B_HOST))
    acc1 = eval_lib.evaluate_classification(mod.model, state.params, ebatches,
                                            2 * B_HOST)["acc1"]
    return losses, acc1


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank spawn, and the one-process references the parent
    computes while the ranks run."""
    out = tmp_path_factory.mktemp("torch_dist")
    X, Y = _dataset()
    jax_mod, jax_state, init = _jax_init()
    torch.save(init, out / "init.pt")
    _write_corpus(str(out / "corpus"))
    threads = torch.get_num_threads()
    procs = _spawn("engine", 2, out)
    torch.set_num_threads(1)
    try:
        jax_losses, jax_acc1 = _jax_reference(jax_mod, jax_state, X, Y)
        epochs = [_global_batches(X, Y, e) for e in range(3)]
        one = _train(init, 2 * B_HOST, 1, epochs, stochastic=True)
        mae_one = _mae_steps(_mae_batch())
        ranks, logs = _wait(procs, out)
    finally:
        torch.set_num_threads(threads)
    return {"out": out, "ranks": ranks, "logs": logs, "jax_losses": jax_losses,
            "jax_acc1": jax_acc1, "one": one, "mae_one": mae_one}


def test_two_ranks_match_jax_single_process(two_ranks):
    """Per-epoch losses of two gloo ranks, each on its shard, within rtol
    2e-4 of JAX's one process over the same global batches; both ranks log
    the same (global) numbers and end with the same parameters."""
    r0, r1 = (r["engine"]["plain"] for r in two_ranks["ranks"])
    np.testing.assert_allclose(r0["losses"], two_ranks["jax_losses"],
                               rtol=2e-4)
    assert r0["losses"] == r1["losses"] and r0["grad_norms"] == r1["grad_norms"]
    assert r0["digest"] == r1["digest"]


def test_two_ranks_dist_eval_acc1_equals_jax(two_ranks):
    """The gathered eval of the ranks' unpadded shards (8 rows each) gives
    JAX's full-set acc1, on both ranks."""
    accs = [r["engine"]["acc1"] for r in two_ranks["ranks"]]
    assert accs[0] == accs[1] == pytest.approx(two_ranks["jax_acc1"], abs=1e-9)


def test_two_ranks_match_one_process_with_stochastic_features(two_ranks):
    """Drop-path 0.1 and 2D masking 0.2 on: each rank draws at the global
    batch's shape and keeps its rows, so the two-rank run is the port's
    one-process run of the same global batches, losses, grad norms and
    final parameters within 1e-5."""
    r0, r1 = (r["engine"]["stochastic"] for r in two_ranks["ranks"])
    losses, norms, state = two_ranks["one"]
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(r0["grad_norms"], norms, rtol=1e-5, atol=1e-5)
    assert r0["digest"] == r1["digest"]
    got = torch.load(two_ranks["out"] / "final_stochastic.pt")
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)
    plain = two_ranks["ranks"][0]["engine"]["plain"]["losses"]
    assert r0["losses"] != plain  # the draws changed the run


def test_pretrain_step_two_ranks_match_one_process(two_ranks):
    """Two MAE steps (2D masking, the swin decoder's dropout) on each rank's
    half of a global batch of 4: the mean of the ranks' losses is the
    one-process loss (rtol 1e-5), and the parameters after the steps differ
    from its own by under 1e-4 of the distance they moved (L2: AdamW's step
    on a gradient entry near 0 follows the summation order, so a single
    entry may move by a few % of lr); the ranks hold equal parameters.
    Left out: the meta-MLPs' ``fc2.bias``, whose gradient is 0 up to
    rounding (the bias shifts every logit of a softmax row alike), so AdamW
    moves it by lr with the sign of the rounding, in one process or two."""
    r0, r1 = (r["engine"]["mae"] for r in two_ranks["ranks"])
    losses, sd = two_ranks["mae_one"]
    np.testing.assert_allclose(
        (np.asarray(r0["losses"]) + np.asarray(r1["losses"])) / 2, losses,
        rtol=1e-5)
    assert r0["digest"] == r1["digest"]
    got = torch.load(two_ranks["out"] / "final_mae.pt")
    start = _mae_model().state_dict()
    diff = moved = 0.0
    for k, v in sd.items():
        if k.endswith("meta_mlp.fc2.bias"):
            continue
        diff += float(((got[k] - v) ** 2).sum())
        moved += float(((v - start[k]) ** 2).sum())
    assert moved > 0 and math.sqrt(diff / moved) < 1e-4, (diff, moved)


def test_finetune_cli_two_ranks(two_ranks):
    """``cli.finetune`` with ``--dist_eval`` over two ranks: equal
    parameters on both, only rank 0 wrote (args.yaml, log.txt, the best
    checkpoint and marker), the logged phases, and the gathered acc1 of
    the best epoch equal to a one-process ``--eval`` of best_model."""
    from tpat_tpu_torch.cli import finetune

    r0, r1 = (r["cli"] for r in two_ranks["ranks"])
    assert r0["ft"]["digest"] == r1["ft"]["digest"]
    assert r0["ft"]["best"] == r1["ft"]["best"]
    out = two_ranks["out"] / "ft"
    assert r1["writes"] == []
    assert any(w.endswith("log.txt") for w in r0["writes"])
    logs = [json.loads(line) for line in open(out / "log.txt")]
    assert [e["train_phase"] for e in logs] == ["dense", "static"]
    best = r0["ft"]["best"]
    assert os.path.isfile(out / "best_model")
    corpus = str(two_ranks["out"] / "corpus")
    stats = finetune.main(finetune.get_args_parser().parse_args(
        _finetune_argv(corpus, str(out), "--eval", "--finetuned_model_path",
                       str(out / "best_model"))), device="cpu")
    assert stats["acc1"] == logs[best["best_epoch"]]["test_acc1"]
    assert stats["acc1"] == best["best_score"]


def test_run_ast_and_pretrain_clis_two_ranks(two_ranks):
    """``cli.run_ast`` and ``cli.pretrain`` over two ranks: equal parameters
    on both ranks, the same returned score or losses, rank-0-only files."""
    r0, r1 = (r["cli"] for r in two_ranks["ranks"])
    for key in ("ast", "pt"):
        assert r0[key]["digest"] == r1[key]["digest"], key
    assert r0["ast"]["best"] == r1["ast"]["best"]
    assert r0["pt"]["losses"] == r1["pt"]["losses"]
    assert all(math.isfinite(v) for v in r0["pt"]["losses"])
    ast_dir, pt_dir = two_ranks["out"] / "ast", two_ranks["out"] / "pt"
    assert os.path.isfile(ast_dir / "models" / "best_audio_model")
    assert os.path.isfile(ast_dir / "result.csv")
    assert os.path.isfile(pt_dir / "mae_pretrained.pth")
    assert os.path.isfile(pt_dir / "checkpoint-000")
    for d in (ast_dir, pt_dir):
        assert any(w.split(" ", 1)[1].startswith(str(d)) for w in r0["writes"])


def test_allgather_rows_three_ranks_ragged(tmp_path):
    """Three ranks (the JAX package's variables) with 5, 4 and 4 rows: every
    rank gets the numpy concatenation; ``check_equal`` raises on every rank
    for a value that differs; ``broadcast_object`` gives rank 0's."""
    procs = _spawn("gather", 3, tmp_path, jax_names=True)
    ranks, _ = _wait(procs, tmp_path)
    want = np.arange(13 * 3, dtype=np.float32).reshape(13, 3)
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["gathered"]), want)
        assert "the rank differs across ranks: 0 to 2" in r["check_error"]
        assert r["object"] == {"from": 0}


# -- pure functions --------------------------------------------------------

@pytest.mark.parametrize("env,explicit,want", [
    ({}, {}, (0, 1, 0, 1, None)),
    ({"COORDINATOR_ADDRESS": "h0:1234", "NUM_PROCESSES": "4",
      "PROCESS_ID": "2", "RANK": "1", "WORLD_SIZE": "8"}, {},
     (2, 4, 2, 4, "h0:1234")),
    ({"RANK": "3", "WORLD_SIZE": "8", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "node0", "MASTER_PORT": "29400",
      "SLURM_PROCID": "5", "SLURM_NTASKS": "16"}, {},
     (3, 8, 1, 4, "node0:29400")),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1",
      "SLURM_NTASKS_PER_NODE": "4", "MASTER_ADDR": "n1"}, {},
     (5, 8, 1, 4, "n1:29500")),
    ({"RANK": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "a", "MASTER_PORT": "1"},
     {"rank": 0, "world": 3, "address": "b:2", "local_rank": 0,
      "local_world": 1}, (0, 3, 0, 1, "b:2")),
])
def test_layout_sources(env, explicit, want):
    """Explicit arguments, then the JAX names, torchrun's, SLURM's; without
    a local rank every process is on this host."""
    from tpat_tpu_torch.parallel.distributed import read_layout

    lay = read_layout(environ=env, **explicit)
    assert (lay.rank, lay.world, lay.local_rank, lay.local_world,
            lay.address) == want


@pytest.mark.parametrize("device,local_world,count,want", [
    ("cpu", 2, 0, "gloo"),
    ("cpu", 1, 4, "gloo"),
    ("cuda", 2, 1, "gloo"),   # two ranks share the card: NCCL refuses that
    ("cuda", 3, 2, "gloo"),
    ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"),
    ("cuda", 2, 8, "nccl"),
    ("cuda", 8, 4, "gloo"),
    ("cuda", 2, 0, RuntimeError),
    ("mps", 1, 0, ValueError),
])
def test_backend_rule(device, local_world, count, want):
    """NCCL where each local rank owns a card, gloo where ranks share one or
    run on the CPU; a CUDA rank without a card, or another device, is
    refused."""
    from tpat_tpu_torch.parallel.distributed import choose_backend

    if isinstance(want, str):
        assert choose_backend(device, local_world, count) == want
    else:
        with pytest.raises(want):
            choose_backend(device, local_world, count)


def test_rank_device_and_rows():
    """cuda:(local_rank % device_count), the CPU as asked; rank r's rows of
    a global batch; the eval padding."""
    from tpat_tpu_torch.parallel.distributed import rank_device
    from tpat_tpu_torch.parallel.mesh import pad_for_eval, rank_rows

    assert rank_device("cuda", 3, 2) == torch.device("cuda", 1)
    assert rank_device("cuda", 1, 1) == torch.device("cuda", 0)
    assert rank_device("cpu", 3, 0) == torch.device("cpu")
    assert rank_rows(4, 1) == slice(4, 8)
    assert [pad_for_eval(n, 3) for n in (9, 10, 11)] == [0, 2, 1]


def test_world_one_draws_and_collectives_are_plain():
    """Without a process group: ``rand_rows`` is ``torch.rand``, the
    collectives leave their inputs as they are, the gather is the
    identity and ``init_distributed_mode`` joins nothing."""
    from tpat_tpu_torch.engine.evaluate import allgather_rows
    from tpat_tpu_torch.parallel import distributed as dist_lib
    from tpat_tpu_torch.parallel.mesh import rand_rows

    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(rand_rows((3, 5), g1), torch.rand((3, 5), generator=g2))
    t = torch.arange(4.0)
    dist_lib.all_reduce_mean_([t])
    dist_lib.broadcast_([t])
    assert torch.equal(t, torch.arange(4.0))
    a = np.ones((2, 3))
    assert allgather_rows(a) is a
    assert dist_lib.broadcast_object(5) == 5
    assert dist_lib.init_distributed_mode("cpu") == (0, 1, torch.device("cpu"))
    assert dist_lib.is_main_process() and dist_lib.world_size() == 1


@pytest.mark.parametrize("n,world", [(8, 1), (8, 2), (7, 3), (2, 3)])
def test_dist_eval_batches_each_row_once(n, world):
    """The ranks' unpadded eval shards, read through ``dist_eval_batches``,
    hold every row exactly once."""
    from tpat_tpu_torch.cli.finetune import dist_eval_batches

    class Rows:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return np.full((1, 2), i, np.float32), np.zeros(4, np.float32), i

    seen = []
    for rank in range(world):
        for x, _y, ids in dist_eval_batches(Rows(), 2, num_workers=1,
                                            world=world, rank=rank):
            assert x[:len(ids), 0, 0].tolist() == ids and len(x)
            seen += ids
    assert sorted(seen) == list(range(n))


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2])
