"""Tensor parallelism (``tpat_tpu/parallel/sharding.py``) on
``torch.distributed``, one process per device.

The JAX package puts a 2-D (data, model) mesh over its devices and gives
the transformer weights Megatron's column/row shardings, and GSPMD inserts
the psum after each row-parallel product.  Here the world's ranks split
into ``tp`` consecutive ranks per model group (``make_mesh_2d``): rank r
has data rank ``r // tp`` and model rank ``r % tp``.  Each rank holds its
cut of the weights (``param_pspec``, in torch's ``(out, in)`` layout):

  attn.qkv  weight (3C, D), bias  -> cut by heads along dim 0 (column)
  mlp.fc1   weight (4D, D), bias  -> cut along dim 0 (column)
  attn.proj weight (D, C)         -> cut along dim 1 (row; bias replicated)
  mlp.fc2   weight (D, 4D)        -> cut along dim 1 (row; bias replicated)
  embeddings, norms, the head     -> replicated

JAX's ``P(None, 'model')`` cuts the packed qkv kernel into tp contiguous
column blocks, which GSPMD can re-gather; here rank r holds
``[q_r | k_r | v_r]``, its own heads of each, so its attention runs over
its ``num_heads / tp`` heads with no permute.  Megatron's two conjugate
operators carry the activations: ``copy_to_model`` (identity forward,
all-reduce backward) before a column-parallel product, and
``reduce_from_model`` (all-reduce forward, identity backward) after a
row-parallel one.  ``torch.distributed.nn.functional.all_reduce`` is not
the second: its backward all-reduces the cotangent too, which would
multiply every replicated gradient by tp.  Both all-reduce in f32 (a bf16
activation is widened, summed, and rounded once).

``shard_state_dict`` and ``gather_state_dict`` go between the tp = 1 state
dict and the ranks' shards (their composition is the identity bit for
bit); ``all_gather_state_dict`` and ``all_gather_optimizer_state`` gather
a rank's shards across its model group through the host, so checkpoints
keep the tp = 1 layout.  The model is cut by ``models.vit.shard_model_``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpat_tpu_torch.parallel import distributed as dist_lib

MODEL_AXIS = "model"
COLUMN_PARALLEL = ("attn.qkv.", "mlp.fc1.")
ROW_PARALLEL = ("attn.proj.weight", "mlp.fc2.weight")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh2D:
    """A (data, model) split of the process group: ``dp`` data ranks of
    ``tp`` model ranks each, and this rank's place and groups in it (None
    without a process group)."""

    dp: int
    tp: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: Any = None
    model_group: Any = None
    host_model_group: Any = None  # the model group over gloo (host tensors)


def make_mesh_2d(dp: int, tp: int) -> Mesh2D:
    """The (dp, tp) mesh over the joined process group, made the active
    mesh (``distributed.set_mesh``).  Every rank makes every model group
    (ranks ``[d*tp, (d+1)*tp)``) and every data group (ranks ``m, m + tp,
    ...``) in the same order, as ``new_group`` requires; under NCCL the
    model groups get a gloo twin for the host-side gathers."""
    rank, world = dist_lib.group_rank_world()
    if dp < 1 or tp < 1 or dp * tp != world:
        raise ValueError(f"a {dp}x{tp} mesh needs {dp * tp} processes, the "
                         f"process group has {world}")
    groups: Dict[str, Any] = {}
    if world > 1:
        twin = dist.get_backend() != "gloo"
        for d in range(dp):
            ranks = list(range(d * tp, (d + 1) * tp))
            g = dist.new_group(ranks)
            h = dist.new_group(ranks, backend="gloo") if twin else g
            if rank in ranks:
                groups.update(model_group=g, host_model_group=h)
        for m in range(tp):
            ranks = list(range(m, world, tp))
            g = dist.new_group(ranks)
            if rank in ranks:
                groups["data_group"] = g
    mesh = Mesh2D(dp, tp, rank // tp, rank % tp, **groups)
    dist_lib.set_mesh(mesh)
    return mesh


def check_divisible(num_heads: int, hidden: int, tp: int) -> None:
    """Refuse a model axis that does not cut the heads or the MLP's hidden
    width evenly."""
    if num_heads % tp:
        raise ValueError(f"num_heads {num_heads} is not divisible by the "
                         f"model axis {tp}")
    if hidden % tp:
        raise ValueError(f"the MLP hidden width {hidden} is not divisible by "
                         f"the model axis {tp}")


def param_pspec(name: str) -> Tuple[Optional[str], ...]:
    """The partition spec of a state-dict entry in torch's layout:
    ``MODEL_AXIS`` at the dim the model axis cuts, () when replicated
    (``_param_pspec`` of the JAX package, whose kernels are (in, out))."""
    if any(c in name for c in COLUMN_PARALLEL):
        return (MODEL_AXIS, None) if name.endswith("weight") else (MODEL_AXIS,)
    if name.endswith(ROW_PARALLEL):
        return (None, MODEL_AXIS)
    return ()


def _cut(name: str) -> Tuple[Optional[int], int]:
    """(the dim the model axis cuts or None, the sections cut alike: 3 for
    the packed [q|k|v])."""
    spec = param_pspec(name)
    if MODEL_AXIS not in spec:
        return None, 1
    return spec.index(MODEL_AXIS), 3 if "attn.qkv." in name else 1


def shard_tensor(name: str, t: torch.Tensor, tp: int, rank: int
                 ) -> torch.Tensor:
    """Model rank ``rank``'s cut of the tp = 1 tensor ``t`` (a copy; ``t``
    itself when replicated)."""
    dim, sections = _cut(name)
    if dim is None or tp == 1:
        return t
    if t.shape[dim] % (sections * tp):
        raise ValueError(f"{name} {tuple(t.shape)}: dim {dim} does not cut "
                         f"into {sections} x {tp}")
    return torch.cat([s.chunk(tp, dim)[rank] for s in t.chunk(sections, dim)],
                     dim)


def unshard_tensor(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tp = 1 tensor from every model rank's cut, in rank order."""
    dim, sections = _cut(name)
    if dim is None or len(shards) == 1:
        return shards[0]
    parts = [s.chunk(sections, dim) for s in shards]
    return torch.cat([torch.cat([p[i] for p in parts], dim)
                      for i in range(sections)], dim)


def shard_state_dict(sd: Mapping[str, torch.Tensor], tp: int, rank: int
                     ) -> Dict[str, torch.Tensor]:
    """Model rank ``rank``'s state dict from the tp = 1 one."""
    return {k: shard_tensor(k, v, tp, rank) for k, v in sd.items()}


def gather_state_dict(shards: Sequence[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """The tp = 1 state dict from every model rank's, in rank order."""
    return {k: unshard_tensor(k, [s[k] for s in shards]) for k in shards[0]}


def _all_gather(t: torch.Tensor, mesh: Mesh2D) -> List[torch.Tensor]:
    """Every model rank's ``t`` (same shape on each), on the host."""
    t = t.detach().cpu().contiguous()
    out = [torch.empty_like(t) for _ in range(mesh.tp)]
    dist.all_gather(out, t, group=mesh.host_model_group)
    return out


def all_gather_state_dict(local: Mapping[str, torch.Tensor], mesh: Mesh2D
                          ) -> Dict[str, torch.Tensor]:
    """The tp = 1 state dict on the host from this rank's cut: a
    collective of the model group, entries in order."""
    if mesh.tp == 1:
        return dict(local)
    return {k: unshard_tensor(k, _all_gather(v, mesh))
            if _cut(k)[0] is not None else v for k, v in local.items()}


def _map_optimizer_state(opt_sd: Dict, names: Sequence[str], fn) -> Dict:
    """``opt_sd`` with ``fn(param name, tensor)`` applied to every
    per-parameter state tensor of more than 0 dims (not AdamW's step)."""
    state = {i: {k: fn(names[i], v)
                 if torch.is_tensor(v) and v.dim() > 0 else v
                 for k, v in st.items()}
             for i, st in opt_sd["state"].items()}
    return {**opt_sd, "state": state}


def shard_optimizer_state(opt_sd: Dict, names: Sequence[str], tp: int,
                          rank: int) -> Dict:
    """Model rank ``rank``'s optimizer state dict from the tp = 1 one;
    ``names[i]`` is the state-dict name of the optimizer's i-th
    parameter."""
    return _map_optimizer_state(
        opt_sd, names, lambda n, v: shard_tensor(n, v, tp, rank))


def all_gather_optimizer_state(opt_sd: Dict, names: Sequence[str],
                               mesh: Mesh2D) -> Dict:
    """The tp = 1 optimizer state dict on the host from this rank's (a
    collective of the model group)."""
    if mesh.tp == 1:
        return opt_sd
    return _map_optimizer_state(
        opt_sd, names, lambda n, v: unshard_tensor(n, _all_gather(v, mesh))
        if _cut(n)[0] is not None else v)


def _all_reduce_f32(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, summed in f32, in ``t``'s dtype (a
    new tensor)."""
    out = t.detach().to(torch.float32, memory_format=torch.contiguous_format,
                        copy=True)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_f32(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_f32(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """f before a column-parallel product; the identity without a group."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """g after a row-parallel product; the identity without a group."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def model_mean(t: torch.Tensor, group, tp: int) -> torch.Tensor:
    """The mean of ``t`` over the model group, outside autograd: every rank
    gets the same bits (the importance scores' mean over all heads, from
    each rank's mean over its own)."""
    return _all_reduce_f32(t, group) / tp
