"""Tensor parallelism of the port (``tpat_tpu_torch/parallel/sharding.py``,
``models.vit.shard_model_``, ``TrainModule(mesh=...)``, the checkpoints and
``cli.finetune --model_axis``) on the CPU, over gloo, mirroring
``tests/test_tensor_parallel.py``.

One spawn of four ranks (``python tests/test_torch_tensor_parallel.py
<dir>``, torchrun's variables, one thread each, a time limit) runs, on each
rank:

- the forward of ``test_tensor_parallel.py``'s config at the (1x4), (2x2)
  and (4x1) meshes, each data rank on its rows; the parent holds the logits
  to JAX's one-device ``model.apply`` (rtol 2e-4, atol 1e-5, JAX's limits);
- the gradients at 2x2, averaged over the data ranks and gathered over the
  model ranks, held to ``jax.grad`` (rtol 5e-4, atol 1e-5);
- ``TrainModule`` at 2x2 on ``test_trainmodule_2d_mesh_matches_single_device``'s
  config (dense, hybrid anneal, static), its losses held to JAX's
  one-device ``TrainModule`` over the same global batches (rtol 2e-4), the
  kept tokens chosen alike on every rank;
- the same run with drop-path, dropout, 2D masking and remat on, held to
  the port's one-process run of the global batches (1e-5): the draws;
- one static forward of the AST flavour ('cls', 2 extras) at 2x2 with its
  features, held to one process;
- a checkpoint payload written at 2x2 (the tp = 1 layout, loaded strict
  into a tp = 1 ``TrainModule``, optimizer included) and a resume at 2x2
  that continues to the uninterrupted run's losses;
- ``cli.finetune --model_axis 2 --dist_eval`` on the tone corpus (the best
  state kept on the device, a ``last_checkpoint`` every epoch), its log
  held to a one-process run of the same global batches (rtol 1e-4), its
  writes audited (rank 0 only), ``best_model`` and ``last_checkpoint`` in
  the tp = 1 layout.

The sharding table, the head cut, ``gather(shard(sd))`` and the refusals are
pure tests.  JAX runs in the parent while the ranks run.  The weights are
sharpened (qkv N(0, 1)) so that the top-k choices are well separated.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_distributed as tdist  # noqa: E402

from tpat_tpu_torch import config as cfg_lib  # noqa: E402
from tpat_tpu_torch.parallel import sharding  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
SPAWN_TIMEOUT = 300  # seconds the spawn of ranks may take
# tests/test_tensor_parallel.py::cfg()
FWD = dict(compute_dtype="float32", embed_dim=64, depth=2, num_heads=4,
           num_classes=5, target_length=64, num_mel_bins=32, drop_loc=(1,),
           base_keep_rate=0.7, drop_path_rate=0.0, attention_impl="xla")
FWD_BATCH = 8
# test_trainmodule_2d_mesh_matches_single_device's configs and batches
TRAIN = dict(compute_dtype="float32", embed_dim=64, depth=3, num_heads=2,
             num_classes=4, target_length=64, num_mel_bins=32, drop_loc=(1,),
             base_keep_rate=0.6, drop_path_rate=0.0, attention_impl="fused")
TRAIN_TC = dict(epochs=4, blr=2e-3, warmup_epochs=1, shrink_start_epoch=1,
                shrink_epochs=1, base_keep_rate=0.6, drop_loc=(1,))
TRAIN_BATCH, TRAIN_STEPS, EPOCHS = 8, 3, 3
STOCHASTIC = dict(drop_path_rate=0.1, drop_rate=0.1, remat=True)
MASK_PROB = 0.2
AST = dict(compute_dtype="float32", embed_dim=64, depth=3, num_heads=4,
           num_classes=7, target_length=128, num_mel_bins=64,
           num_extra_tokens=2, importance="cls", pooling="cls_dist",
           pos_embed_mode="post_cat", use_final_norm=True,
           frozen_pos_embed=False, drop_path_rate=0.0, drop_loc=(1,),
           base_keep_rate=0.6, attention_impl="xla")
CLI_HEADS = 4  # audiomae_vit_tiny's 3 heads do not cut in 2
LOG_KEYS = ("train_loss", "train_grad_norm", "test_acc1", "test_acc5")


# -- shared by the parent and the ranks -----------------------------------

def _fwd_input():
    rng = np.random.default_rng(1)
    return rng.normal(size=(FWD_BATCH, 1, 64, 32)).astype(np.float32)


def _fwd_targets():
    return np.eye(5, dtype=np.float32)[np.arange(FWD_BATCH) % 5]


def _train_batches():
    rng = np.random.default_rng(5)
    out = []
    for _ in range(TRAIN_STEPS):
        y_idx = rng.integers(0, 4, size=TRAIN_BATCH)
        x = rng.normal(size=(TRAIN_BATCH, 1, 64, 32)).astype(np.float32)
        x[np.arange(TRAIN_BATCH), 0, 0, 0] = y_idx * 2.0
        out.append((x, np.eye(4, dtype=np.float32)[y_idx]))
    return out


def _ast_input():
    rng = np.random.default_rng(7)
    return rng.normal(size=(FWD_BATCH, 1, 64, 128)).astype(np.float32)


def _sharpened_sd(model):
    """The port model's state dict with qkv drawn N(0, 1) (well-separated
    top-k choices)."""
    g = torch.Generator().manual_seed(3)
    return {k: torch.randn(v.shape, generator=g) if ".qkv." in k else v
            for k, v in model.state_dict().items()}


def _tiny_heads():
    """``audiomae_vit_tiny`` with ``CLI_HEADS`` heads (patched in the CLI
    runs)."""
    real = cfg_lib.audiomae_vit_tiny
    cfg_lib.audiomae_vit_tiny = lambda **kw: dataclasses.replace(
        real(**kw), num_heads=CLI_HEADS)
    return real


def _train(sd, stochastic, mesh=None, epochs=range(EPOCHS), state=None,
           payloads=None):
    """The port's TrainModule over the global batches (each data rank on
    its rows under ``mesh``); per-epoch losses and grad norms, the state,
    and the kept-token ids of each drop block of every step."""
    from tpat_tpu_torch.config import TrainConfig, ViTConfig
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.ops import pruning
    from tpat_tpu_torch.utils import checkpoint as ckpt_lib

    dp, d = (1, 0) if mesh is None else (mesh.dp, mesh.data_rank)
    b = TRAIN_BATCH // dp
    extra = dict(mask_t_prob=MASK_PROB, mask_f_prob=MASK_PROB) if stochastic else {}
    cfg = ViTConfig(**{**TRAIN, **(STOCHASTIC if stochastic else {})})
    tc = TrainConfig(batch_size=b, num_hosts=dp, **TRAIN_TC, **extra)
    mod = TrainModule(cfg, tc, "ce", iters_per_epoch=TRAIN_STEPS,
                      device="cpu", mesh=mesh)
    if state is None:
        state = mod.load(sd, seed=9)
    batches = [(x[d * b:(d + 1) * b], y[d * b:(d + 1) * b])
               for x, y in _train_batches()]
    kept, topk = [], pruning.topk_select

    def recording(scores, k):
        idx = topk(scores, k)
        kept.append(idx.clone())
        return idx

    losses, norms = [], []
    pruning.topk_select = recording
    try:
        for epoch in epochs:
            state, stats = mod.train_epoch(state, batches, epoch)
            losses.append(stats["loss"])
            norms.append(stats["grad_norm"])
            if payloads is not None:
                payloads.append(ckpt_lib.state_payload(state, epoch))
    finally:
        pruning.topk_select = topk
    return {"losses": losses, "norms": norms, "kept": kept,
            "attention_impl": mod.model_cfg.attention_impl}, state


# -- the ranks -------------------------------------------------------------

def _rank_forward(out):
    """Logits of each data rank's rows at (1x4), (2x2) and (4x1)."""
    from tpat_tpu_torch.config import ViTConfig
    from tpat_tpu_torch.models.vit import AudioViT, shard_model_

    sd = torch.load(os.path.join(out, "fwd.pt"))
    x = torch.from_numpy(_fwd_input())
    res = {}
    for dp, tp in ((1, 4), (2, 2), (4, 1)):
        mesh = sharding.make_mesh_2d(dp, tp)
        model = AudioViT(ViTConfig(**FWD))
        model.load_state_dict(sd)
        shard_model_(model, mesh).eval()
        b = FWD_BATCH // dp
        with torch.no_grad():
            res[f"{dp}x{tp}"] = model(x[mesh.data_rank * b:
                                        (mesh.data_rank + 1) * b])
    return res


def _rank_grads(out, mesh):
    """The CE gradient of the global batch's mean loss, averaged over the
    data ranks and gathered over the model ranks, as a tp = 1 state dict."""
    from tpat_tpu_torch.config import ViTConfig
    from tpat_tpu_torch.engine.train import soft_cross_entropy
    from tpat_tpu_torch.models.vit import AudioViT, shard_model_
    from tpat_tpu_torch.parallel import distributed as dist_lib

    model = AudioViT(ViTConfig(**FWD))
    model.load_state_dict(torch.load(os.path.join(out, "fwd.pt")))
    shard_model_(model, mesh).eval()
    b = FWD_BATCH // mesh.dp
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    x = torch.from_numpy(_fwd_input())[rows]
    y = torch.from_numpy(_fwd_targets())[rows]
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(soft_cross_entropy(model(x), y),
                                [p for _, p in named])
    grads = [g.clone() for g in grads]
    dist_lib.all_reduce_mean_(grads, group=mesh.data_group)
    return sharding.all_gather_state_dict(
        {n: g for (n, _), g in zip(named, grads)}, mesh)


def _rank_train(out, mesh):
    """TrainModule at 2x2 (plain and stochastic), the payloads after each
    epoch of the plain run, and a resume from epoch 0's."""
    from tpat_tpu_torch.utils import checkpoint as ckpt_lib

    sd = torch.load(os.path.join(out, "train.pt"))
    payloads = []
    plain, state = _train(sd, False, mesh, payloads=payloads)
    plain["local_qkv_rows"] = state.model.blocks[0].attn.qkv.weight.shape[0]
    plain["params"] = [p.detach().clone() for p in state.params]
    stochastic, state = _train(sd, True, mesh)
    stochastic["final"] = ckpt_lib.state_payload(state, EPOCHS - 1)["model"]
    # a resume from epoch 0's payload, as --resume does
    fresh = _train(sd, False, mesh, epochs=())[1]
    ckpt_lib.load_state(fresh, payloads[0])
    resumed, _ = _train(sd, False, mesh, epochs=range(1, EPOCHS), state=fresh)
    return {"plain": plain, "stochastic": stochastic, "resumed": resumed,
            "payload": payloads[-1]}


def _rank_ast(out, mesh):
    """One static AST forward at 2x2 with its features."""
    from tpat_tpu_torch.config import ViTConfig
    from tpat_tpu_torch.models.vit import AudioViT, shard_model_

    model = AudioViT(ViTConfig(**AST))
    model.load_state_dict(torch.load(os.path.join(out, "ast.pt")))
    shard_model_(model, mesh).eval()
    b = FWD_BATCH // mesh.dp
    x = torch.from_numpy(_ast_input())[mesh.data_rank * b:
                                       (mesh.data_rank + 1) * b]
    with torch.no_grad():
        return model(x, extract_features=True)


def _rank_cli(out):
    from tpat_tpu_torch.cli import finetune

    writes = []
    tdist._audit_writes((os.path.join(out, "ft"),), writes)
    _tiny_heads()
    sys.modules["torch.utils.tensorboard"] = None  # no TensorBoard writer
    best = finetune.main(finetune.get_args_parser().parse_args(
        tdist._finetune_argv(os.path.join(out, "corpus"),
                             os.path.join(out, "ft"), "--dist_eval",
                             "--model_axis", "2", "--best_on_device", "true",
                             "--save_every_epochs", "1")), device="cpu")
    return {"best": best, "writes": writes}


def _rank_main(out):
    torch.set_num_threads(1)
    from tpat_tpu_torch.parallel import distributed as dist_lib

    rank, world, _ = dist_lib.init_distributed_mode("cpu", timeout=120)
    res = {"forward": _rank_forward(out)}
    mesh = sharding.make_mesh_2d(2, 2)
    res.update(grads=_rank_grads(out, mesh), train=_rank_train(out, mesh),
               ast=_rank_ast(out, mesh), mesh=(mesh.data_rank, mesh.model_rank))
    res["cli"] = _rank_cli(out)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    dist_lib.leave()


# -- the parent ------------------------------------------------------------

def _spawn(out):
    env = {k: v for k, v in os.environ.items() if k not in tdist.LAUNCH_VARS}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    port = tdist._free_port()
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(out)],
        env={**env, "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
             "WORLD_SIZE": str(WORLD), "RANK": str(r), "LOCAL_RANK": str(r),
             "LOCAL_WORLD_SIZE": str(WORLD)},
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)]


def _wait(procs, out):
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
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _jax_references(out):
    """JAX's one-device forward, gradients and TrainModule losses; the
    sharpened weights they start from, saved for the ranks."""
    import jax
    import jax.numpy as jnp

    from tpat_tpu.config import TrainConfig as JTrainConfig
    from tpat_tpu.config import ViTConfig as JViTConfig
    from tpat_tpu.engine.train import TrainModule as JTrainModule
    from tpat_tpu.models.vit import AudioViT as JAudioViT
    from test_tensor_parallel import cfg as jax_fwd_cfg
    from test_torch_train import _sharpened
    from tpat_tpu_torch.utils.weights import state_dict_from_jax

    def to_sd(tree):
        return state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree))

    fcfg = JViTConfig(**FWD)
    assert fcfg == jax_fwd_cfg()
    model = JAudioViT(fcfg)
    params = _sharpened(fcfg, seed=0)
    torch.save(to_sd(params), os.path.join(out, "fwd.pt"))
    x, y = jnp.asarray(_fwd_input()), jnp.asarray(_fwd_targets())
    logits = np.asarray(jax.jit(lambda p, x: model.apply({"params": p}, x))(
        params, x))

    def loss_fn(p, x):
        out = model.apply({"params": p}, x)
        return -jnp.mean(jnp.sum(y * jax.nn.log_softmax(out), -1))

    grads = to_sd(jax.jit(jax.grad(loss_fn))(params, x))

    tcfg = JViTConfig(**dict(TRAIN, attention_impl="xla"))
    tparams = _sharpened(tcfg, seed=1)
    torch.save(to_sd(tparams), os.path.join(out, "train.pt"))
    mod = JTrainModule(model=JAudioViT(tcfg), model_cfg=tcfg,
                       train_cfg=JTrainConfig(batch_size=TRAIN_BATCH, **TRAIN_TC),
                       loss_type="ce", iters_per_epoch=TRAIN_STEPS)
    state = mod.load(tparams, seed=9)
    losses, norms = [], []
    for epoch in range(EPOCHS):
        state, stats = mod.train_epoch(state, _train_batches(), epoch)
        losses.append(float(stats["loss"]))
        norms.append(float(stats["grad_norm"]))
    return {"logits": logits, "grads": grads, "losses": losses,
            "norms": norms}


class _TwoShardOrder:
    """A one-process sampler giving the global batches of two data ranks of
    ``batch`` rows each: rank 0's rows of each step, then rank 1's."""

    batch = 4

    def __init__(self, dataset_len, shuffle=True, seed=0, world=1, rank=0):
        from tpat_tpu_torch.data.sampler import EpochShardSampler

        self.shards = [EpochShardSampler(dataset_len, shuffle, seed, 2, r)
                       for r in range(2)]

    def set_epoch(self, epoch):
        for s in self.shards:
            s.set_epoch(epoch)

    def __iter__(self):
        a, b = (s.indices() for s in self.shards)
        n = self.batch
        return iter([i for k in range(0, len(a), n)
                     for i in a[k:k + n] + b[k:k + n]])

    def __len__(self):
        return 2 * len(self.shards[0])


def _one_process_cli(out):
    """``cli.finetune`` in one process over the ranks' global batches."""
    from tpat_tpu_torch.cli import finetune

    real_tiny, real_sampler = _tiny_heads(), finetune.EpochShardSampler
    finetune.EpochShardSampler = _TwoShardOrder
    tb = "torch.utils.tensorboard"
    had, prev = tb in sys.modules, sys.modules.get(tb)
    sys.modules[tb] = None  # no TensorBoard writer
    try:
        argv = tdist._finetune_argv(str(out / "corpus"), str(out / "ft_one"))
        argv[argv.index("--batch_size") + 1] = str(2 * _TwoShardOrder.batch)
        finetune.main(finetune.get_args_parser().parse_args(argv),
                      device="cpu")
    finally:
        cfg_lib.audiomae_vit_tiny = real_tiny
        finetune.EpochShardSampler = real_sampler
        if had:
            sys.modules[tb] = prev
        else:
            del sys.modules[tb]
    with open(out / "ft_one" / "log.txt") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four-rank spawn, and the references the parent computes while
    the ranks run."""
    from tpat_tpu_torch.config import ViTConfig
    from tpat_tpu_torch.models.vit import AudioViT

    out = tmp_path_factory.mktemp("torch_tp")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jax_ref = _jax_references(out)
        ast = AudioViT(ViTConfig(**AST),
                       generator=torch.Generator().manual_seed(2))
        ast.load_state_dict(_sharpened_sd(ast))
        torch.save(ast.state_dict(), out / "ast.pt")
        tdist._write_corpus(str(out / "corpus"))
        procs = _spawn(out)
        try:
            train_sd = torch.load(out / "train.pt")
            one, state = _train(train_sd, True)
            one["state_dict"] = state.model.state_dict()
            with torch.no_grad():
                ast_one = ast.eval()(torch.from_numpy(_ast_input()),
                                     extract_features=True)
            cli_one = _one_process_cli(out)
        finally:
            ranks = _wait(procs, out)
    finally:
        torch.set_num_threads(threads)
    return {"out": out, "ranks": ranks, "jax": jax_ref, "one": one,
            "ast_one": ast_one, "cli_one": cli_one, "train_sd": train_sd}


@pytest.mark.parametrize("dp,tp", [(1, 4), (2, 2), (4, 1)])
def test_tp_forward_matches_jax_single_device(four_ranks, dp, tp):
    """Each rank's logits of its data rank's rows within rtol 2e-4, atol
    1e-5 of JAX's one-device forward; the ranks of a model group agree bit
    for bit."""
    want = four_ranks["jax"]["logits"]
    b = FWD_BATCH // dp
    for rank, r in enumerate(four_ranks["ranks"]):
        d = rank // tp
        got = r["forward"][f"{dp}x{tp}"].numpy()
        np.testing.assert_allclose(got, want[d * b:(d + 1) * b], rtol=2e-4,
                                   atol=1e-5)
        lead = four_ranks["ranks"][d * tp]["forward"][f"{dp}x{tp}"]
        assert torch.equal(r["forward"][f"{dp}x{tp}"], lead)


def test_tp_gradients_match_jax_single_device(four_ranks):
    """At 2x2 the gradients, averaged over the data ranks and gathered over
    the model ranks, are ``jax.grad``'s within rtol 5e-4, atol 1e-5, on
    every rank."""
    want = four_ranks["jax"]["grads"]
    for r in four_ranks["ranks"]:
        got = r["grads"]
        assert got.keys() <= want.keys() and len(got) > 20
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=5e-4,
                                       atol=1e-5, err_msg=k)


def test_trainmodule_2x2_matches_jax_single_device(four_ranks):
    """TrainModule at 2x2 (dense, hybrid anneal, static): the attention is
    forced to 'xla', each rank holds half of the qkv rows, the losses are
    JAX's one-device ``TrainModule``'s over the same global batches within
    rtol 2e-4, the grad norms too; every rank logs the same numbers and
    keeps the same tokens as the others of its model group."""
    jax_ref = four_ranks["jax"]
    ranks = [r["train"]["plain"] for r in four_ranks["ranks"]]
    for r in ranks:
        assert r["attention_impl"] == "xla"
        assert r["local_qkv_rows"] == 3 * TRAIN["embed_dim"] // 2
        np.testing.assert_allclose(r["losses"], jax_ref["losses"], rtol=2e-4)
        np.testing.assert_allclose(r["norms"], jax_ref["norms"], rtol=2e-4)
        assert r["losses"] == ranks[0]["losses"]
    for a, b in ((0, 1), (2, 3)):
        assert len(ranks[a]["kept"]) == len(ranks[b]["kept"]) > 0
        assert all(torch.equal(x, y) for x, y in
                   zip(ranks[a]["kept"], ranks[b]["kept"]))
    # the data ranks' replicas of each cut are equal
    for a, b in ((0, 2), (1, 3)):
        assert all(torch.equal(x, y) for x, y in
                   zip(ranks[a]["params"], ranks[b]["params"]))


def test_draws_at_2x2_match_one_process(four_ranks):
    """Drop-path 0.1, dropout 0.1, 2D masking 0.2 and remat on: at 2x2 the
    losses, grad norms and gathered final parameters are the port's
    one-process run of the global batches within 1e-5, and the kept tokens
    of each data rank are the one process's rows of them."""
    one = four_ranks["one"]
    for rank, r in enumerate(four_ranks["ranks"]):
        s = r["train"]["stochastic"]
        np.testing.assert_allclose(s["losses"], one["losses"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(s["norms"], one["norms"], rtol=1e-5,
                                   atol=1e-5)
        d = rank // 2
        assert len(s["kept"]) == len(one["kept"]) > 0
        for got, want in zip(s["kept"], one["kept"]):
            b = want.shape[0] // 2
            assert torch.equal(got, want[d * b:(d + 1) * b])
    plain = four_ranks["ranks"][0]["train"]["plain"]["losses"]
    assert four_ranks["ranks"][0]["train"]["stochastic"]["losses"] != plain
    final = four_ranks["ranks"][0]["train"]["stochastic"]["final"]
    assert final.keys() == one["state_dict"].keys()
    for k, v in one["state_dict"].items():
        np.testing.assert_allclose(final[k].numpy(), v.numpy(), atol=1e-5,
                                   err_msg=k)


def test_ast_flavour_at_2x2_matches_one_process(four_ranks):
    """The AST flavour ('cls' importance, 2 extra tokens, cls_dist pooling):
    one static forward at 2x2 with its features equals one process's rows
    (logits and scores rtol 2e-4, atol 1e-5; the kept indices equal)."""
    logits_one, feats_one = four_ranks["ast_one"]
    for rank, r in enumerate(four_ranks["ranks"]):
        logits, feats = r["ast"]
        d, b = rank // 2, FWD_BATCH // 2
        rows = slice(d * b, (d + 1) * b)
        np.testing.assert_allclose(logits.numpy(), logits_one[rows].numpy(),
                                   rtol=2e-4, atol=1e-5)
        assert feats.keys() == feats_one.keys()
        for k, v in feats.items():
            if k.endswith("topk_idx"):
                assert torch.equal(v, feats_one[k][rows]), k
            else:
                np.testing.assert_allclose(v.numpy(), feats_one[k][rows].numpy(),
                                           rtol=2e-4, atol=1e-5, err_msg=k)


def test_payload_at_2x2_loads_into_tp1_trainmodule(four_ranks):
    """The payload written at 2x2 is in the tp = 1 layout: it loads strict
    into a tp = 1 ``TrainModule``, optimizer included, whose parameters
    and AdamW moments then have the full shapes; the model ranks' payloads
    are equal."""
    from tpat_tpu_torch.config import TrainConfig, ViTConfig
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.utils import checkpoint as ckpt_lib

    payload = four_ranks["ranks"][0]["train"]["payload"]
    other = four_ranks["ranks"][1]["train"]["payload"]
    for k, v in payload["model"].items():
        assert torch.equal(v, other["model"][k]), k
    mod = TrainModule(ViTConfig(**TRAIN),
                      TrainConfig(batch_size=TRAIN_BATCH, **TRAIN_TC), "ce",
                      iters_per_epoch=TRAIN_STEPS, device="cpu")
    state = mod.load(four_ranks["train_sd"], seed=9)
    ckpt_lib.load_state(state, payload)
    sd = state.model.state_dict()
    for k, v in payload["model"].items():
        assert torch.equal(sd[k], v), k
    qkv = state.model.blocks[0].attn.qkv.weight
    moments = state.optimizer.state[qkv]
    assert moments["exp_avg"].shape == qkv.shape == (3 * 64, 64)
    assert state.step == EPOCHS * TRAIN_STEPS


def test_resume_at_2x2_continues_the_run(four_ranks):
    """A resume at 2x2 from epoch 0's payload gives the uninterrupted run's
    losses of epochs 1 and 2, on every rank."""
    for r in four_ranks["ranks"]:
        t = r["train"]
        assert t["resumed"]["losses"] == t["plain"]["losses"][1:]
        assert t["resumed"]["norms"] == t["plain"]["norms"][1:]


def test_finetune_cli_model_axis_2(four_ranks):
    """``cli.finetune --model_axis 2 --dist_eval --best_on_device true
    --save_every_epochs 1`` at world 4 (2 data x 2 model ranks): the log
    within rtol 1e-4 of one process over the same global batches (train
    loss and grad norm, acc1, acc5; the test loss is each rank's own
    shard's, as in JAX), the same phases, only rank 0 wrote, ``best_model``
    (the device snapshot, gathered at the end) loads strict into a tp = 1
    ``AudioViT`` and its one-process ``--eval`` gives the logged best acc1;
    ``last_checkpoint`` holds the tp = 1 model and AdamW moments."""
    from tpat_tpu_torch.cli import finetune
    from tpat_tpu_torch.models.vit import AudioViT

    out = four_ranks["out"] / "ft"
    ranks = [r["cli"] for r in four_ranks["ranks"]]
    assert all(r["best"] == ranks[0]["best"] for r in ranks)
    assert ranks[0]["writes"] and not any(r["writes"] for r in ranks[1:])
    with open(out / "log.txt") as f:
        logs = [json.loads(line) for line in f]
    one = four_ranks["cli_one"]
    assert [e["train_phase"] for e in logs] == [e["train_phase"] for e in one] \
        == ["dense", "static"]
    for got, want in zip(logs, one):
        for k in LOG_KEYS:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    payload = torch.load(out / "best_model")
    last = torch.load(out / "last_checkpoint")
    real = _tiny_heads()
    try:
        cfg = cfg_lib.audiomae_vit_tiny(num_classes=4, target_length=128,
                                        drop_loc=(1, 3), base_keep_rate=0.6,
                                        compute_dtype="float32")
        model = AudioViT(cfg)
        model.load_state_dict(payload["model"], strict=True)
        model.load_state_dict(last["model"], strict=True)
        opt = last["optimizer"]
        for group in opt["param_groups"]:
            for i, name in zip(group["params"], group["names"]):
                assert (opt["state"][i]["exp_avg"].shape
                        == last["model"][name].shape), name
        assert last["model"]["blocks.0.attn.qkv.weight"].shape == (576, 192)
        assert last["epoch"] == 1
        argv = tdist._finetune_argv(str(four_ranks["out"] / "corpus"),
                                    str(out), "--eval",
                                    "--finetuned_model_path",
                                    str(out / "best_model"))
        stats = finetune.main(finetune.get_args_parser().parse_args(argv),
                              device="cpu")
    finally:
        cfg_lib.audiomae_vit_tiny = real
    best = ranks[0]["best"]
    assert stats["acc1"] == logs[best["best_epoch"]]["test_acc1"]


# -- pure functions --------------------------------------------------------

@pytest.mark.parametrize("name,spec", [
    ("blocks.0.attn.qkv.weight", ("model", None)),
    ("blocks.0.attn.qkv.bias", ("model",)),
    ("blocks.0.attn.proj.weight", (None, "model")),
    ("blocks.0.attn.proj.bias", ()),
    ("blocks.0.mlp.fc1.weight", ("model", None)),
    ("blocks.0.mlp.fc1.bias", ("model",)),
    ("blocks.0.mlp.fc2.weight", (None, "model")),
    ("blocks.0.mlp.fc2.bias", ()),
    ("pos_embed", ()),
    ("blocks.0.norm1.weight", ()),
    ("head.weight", ()),
    ("patch_embed.proj.weight", ()),
])
def test_param_sharding_rules(name, spec):
    """``test_param_sharding_rules``'s table in torch's (out, in) layout:
    qkv and fc1 column-parallel (dim 0 of the weight and the bias), proj
    and fc2 row-parallel (dim 1, the bias replicated), the rest
    replicated."""
    assert sharding.param_pspec(name) == spec


def test_qkv_is_cut_by_heads():
    """Rank r's qkv rows are [q_r | k_r | v_r]: its own heads of each
    section, so its attention needs no permute."""
    c, heads, tp = 8, 4, 2
    hd = c // heads
    w = torch.arange(3 * c, dtype=torch.float32)[:, None].expand(3 * c, 2)
    for r in range(tp):
        got = sharding.shard_tensor("blocks.1.attn.qkv.weight", w, tp, r)[:, 0]
        mine = [s * c + h * hd + i for s in range(3)
                for h in range(r * heads // tp, (r + 1) * heads // tp)
                for i in range(hd)]
        assert got.tolist() == mine


@pytest.mark.parametrize("tp", [2, 4])
def test_gather_of_shard_is_identity(tp):
    """``gather_state_dict`` of every model rank's ``shard_state_dict`` is
    the tp = 1 state dict bit for bit, and so is the AdamW state."""
    from tpat_tpu_torch.config import ViTConfig
    from tpat_tpu_torch.models.vit import AudioViT

    sd = AudioViT(ViTConfig(**FWD)).state_dict()
    shards = [sharding.shard_state_dict(sd, tp, r) for r in range(tp)]
    assert shards[0]["blocks.0.attn.qkv.weight"].shape == (3 * 64 // tp, 64)
    assert shards[0]["blocks.0.mlp.fc2.weight"].shape == (64, 256 // tp)
    back = sharding.gather_state_dict(shards)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], v) for k, v in sd.items())
    names = list(sd)
    opt = {"state": {i: {"step": torch.tensor(3.0),
                         "exp_avg": torch.randn(v.shape)}
                     for i, v in enumerate(sd.values())},
           "param_groups": [{"params": list(range(len(sd)))}]}
    cut = [sharding.shard_optimizer_state(opt, names, tp, r)
           for r in range(tp)]
    for i, st in opt["state"].items():
        got = sharding.unshard_tensor(
            names[i], [c["state"][i]["exp_avg"] for c in cut])
        assert torch.equal(got, st["exp_avg"])


@pytest.mark.parametrize("kw,tp,match", [
    (dict(num_heads=3, embed_dim=48), 2, "num_heads 3 "),
    (dict(mlp_ratio=250 / 64), 4, "hidden width 250 "),
])
def test_refuses_what_does_not_cut(kw, tp, match):
    """A model axis that does not divide the heads or the MLP's hidden
    width is refused by ``TrainModule`` and by ``shard_model_``."""
    from tpat_tpu_torch.config import TrainConfig, ViTConfig
    from tpat_tpu_torch.engine.train import TrainModule
    from tpat_tpu_torch.models.vit import AudioViT, shard_model_

    cfg = ViTConfig(**dict(FWD, **kw))
    mesh = sharding.Mesh2D(1, tp)
    with pytest.raises(ValueError, match=match):
        TrainModule(cfg, TrainConfig(batch_size=4), "ce", iters_per_epoch=1,
                    device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match=match):
        shard_model_(AudioViT(cfg), mesh)


@pytest.mark.parametrize("dp,tp", [(2, 2), (1, 2), (0, 1)])
def test_mesh_must_cover_the_world(dp, tp):
    """``make_mesh_2d`` refuses dp x tp other than the process count (one
    here, without a process group)."""
    with pytest.raises(ValueError, match="mesh needs"):
        sharding.make_mesh_2d(dp, tp)


def test_mesh_of_one_and_f_g_without_a_group():
    """The 1x1 mesh of one process: data rank 0 of a data world of 1, no
    groups; f and g are the identity without a group."""
    from tpat_tpu_torch.parallel import distributed as dist_lib

    mesh = sharding.make_mesh_2d(1, 1)
    try:
        assert (mesh.dp, mesh.tp, mesh.data_rank, mesh.model_rank) == (1, 1, 0, 0)
        assert dist_lib.data_rank_world() == (0, 1)
        assert mesh.model_group is None and mesh.data_group is None
    finally:
        dist_lib.set_mesh(None)
    x = torch.randn(3)
    assert sharding.copy_to_model(x, None) is x
    assert sharding.reduce_from_model(x, None) is x


if __name__ == "__main__":
    _rank_main(sys.argv[1])
