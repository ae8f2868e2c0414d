"""Device mesh, sharding rules and collectives over ``torch.distributed``:
the port of ``learning_embeddings_tpu/parallel/mesh.py``.

The JAX package runs one GSPMD program over a ``('data', 'model')``
``jax.sharding.Mesh``: batches shard over 'data', parameters are
replicated (XLA inserts the gradient all-reduce), and wide output layers
(the head's ``fc/kernel``) may shard over 'model'. A sharded program
computes what the unsharded one computes. Here every rank of a process
group is one place of the grid and runs the same Python, and the
collectives GSPMD would insert are written out:

* ``Mesh`` / ``make_mesh``: the grid, rank r at (r // n_model,
  r % n_model) as JAX's ``devices[:use].reshape(n_data, n_model)``, with
  this rank's 'data' group (the ranks of its column: same model index) and
  'model' group (its row), and its ``torch.device``: ``cuda:{local rank %
  device count}``, so several ranks may share one card. A group of one
  rank is ``None``: collectives over it are the identity.
* ``shard_rows`` / ``all_gather_rows``: the counterparts of
  ``batch_sharding`` and ``replicated``: this rank's block of a batch, and
  the whole of it on every rank (a tensor every rank computed whole, as
  the replicated parameters, is already that).
* ``param_shardings``: the JAX rule, applied to each parameter's JAX path
  and shape (``models/jax_import.py::jax_param_path``); ``ShardedLinear``
  carries it out for a linear layer (column-parallel over the fan-out, or
  row-parallel over the fan-in with the partial outputs summed).
* collectives built on ``all_reduce`` alone (gloo takes CUDA tensors for
  ``all_reduce`` and ``broadcast`` only): an all-gather is a zeroed buffer
  with this rank's block written in, summed, which is exact (x + 0 = x);
  the autograd forms ``gather_rows`` (backward: the gradient summed over
  the group, or not, then this rank's block), ``copy_to_group``
  (identity forward, sum backward) and ``reduce_from_group`` (sum
  forward, identity backward). Every call counts as "collective_<tag>"
  and runs in the device span ``collective.<tag>``
  (``utils/profiling.py``: under a profiler, its event pair on the
  compute stream times what the collective holds that stream up, with no
  synchronise); nothing catches a failed collective.
* ``init_from_env``: the default process group of a rank that ``torchrun``
  started, with a time limit on every collective.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..utils import profiling

__all__ = ["Mesh", "make_mesh", "mesh_device", "init_from_env",
           "default_backend", "shard_rows", "shard_height",
           "param_shardings",
           "ParamSharding", "ShardedLinear", "shard_linear_layers_",
           "all_reduce_", "all_gather_rows", "gather_rows", "copy_to_group",
           "reduce_from_group", "all_reduce_grads_", "barrier",
           "group_rank", "group_size", "is_writer", "check_batch_divides",
           "global_step_outputs", "DEFAULT_TIMEOUT_S"]

#: time limit of every collective of a process group this module starts
DEFAULT_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A ('data', 'model') grid over the ranks of the default process group
    (or over this one process, for a 1 × 1 mesh without one).

    ``shape`` maps the axis names to their sizes, as a JAX mesh's does;
    ``data_index`` / ``model_index`` are this rank's coordinates;
    ``data_group`` holds the ranks that share this rank's model index
    (batch shards, reduced over for BatchNorm statistics and gradients),
    ``model_group`` those that share its data index (tensor-parallel and
    spatial shards), ``world_group`` every rank of the mesh (the
    BatchNorm statistics of a layer sharded over both axes); each is None
    when it holds one rank."""

    axis_names = ("data", "model")

    def __init__(self, n_data: int, n_model: int, device: torch.device,
                 rank: int = 0, data_group=None, model_group=None,
                 world_group=None):
        self.shape = {"data": int(n_data), "model": int(n_model)}
        self.rank = int(rank)
        self.data_index, self.model_index = divmod(self.rank, int(n_model))
        self.device = torch.device(device)
        self.data_group = data_group
        self.model_group = model_group
        self.world_group = world_group

    @property
    def n_data(self) -> int:
        return self.shape["data"]

    @property
    def n_model(self) -> int:
        return self.shape["model"]

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    def __repr__(self) -> str:
        return (f"Mesh(data={self.n_data}, model={self.n_model}, "
                f"rank={self.rank} at ({self.data_index}, "
                f"{self.model_index}), device={self.device})")


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def mesh_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card ``local rank % device count``
    (``LOCAL_RANK`` from the environment, else the global rank) for
    ``"cuda"``; raises if no card is present."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"a mesh runs on 'cpu' or 'cuda', not {device}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was asked for but no CUDA card is available; "
            "pass device='cpu' to run on the CPU")
    if device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", _world()[1]))
    return torch.device("cuda", local % torch.cuda.device_count())


def _new_group(ranks) -> Optional[object]:
    # every rank creates every group, in the same order (torch.distributed
    # requires it); a group of one rank is no group
    ranks = [int(r) for r in ranks]
    return dist.new_group(ranks) if len(ranks) > 1 else None


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device="cuda") -> Mesh:
    """('data', 'model') mesh over the ranks of the default process group
    (one rank without one). Raises the JAX package's error when the grid
    does not fit the ranks, and also when it leaves ranks out: a rank
    outside the grid would have no part in the program."""
    world, rank = _world()
    if n_data is None:
        n_data = world // n_model
    use = n_data * n_model
    if use == 0 or use > world:
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model) = {use} devices does "
            f"not fit the {world} available device(s)")
    if use < world:
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model) = {use} devices leaves "
            f"{world - use} of the {world} ranks out; every rank of the "
            f"process group takes a place in the mesh")
    device = mesh_device(device)
    grid = np.arange(use).reshape(n_data, n_model)
    data_groups = [_new_group(grid[:, m]) for m in range(n_model)]
    model_groups = [_new_group(grid[d]) for d in range(n_data)]
    world_group = _new_group(grid.reshape(-1))
    d, m = divmod(rank, n_model)
    return Mesh(n_data, n_model, device, rank, data_groups[m],
                model_groups[d], world_group)


def default_backend(device, n_local_ranks: int) -> str:
    """gloo on the CPU and for several ranks per card (NCCL refuses two
    ranks on one card); NCCL when every rank has a card of its own."""
    if torch.device(device).type == "cpu":
        return "gloo"
    return ("nccl" if n_local_ranks <= torch.cuda.device_count()
            else "gloo")


def init_from_env(backend: Optional[str] = None, device="cuda",
                  timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Starts the default process group of a rank launched by ``torchrun``
    (``python -m torch.distributed.run``), which sets RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT. Every
    collective of the group fails after `timeout_s` seconds."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_from_env: {missing} not set; start the "
                           f"ranks with torchrun")
    world = int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = backend or default_backend(device, local_world)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(mesh_device(device))
    dist.init_process_group(
        backend, init_method="env://", rank=int(os.environ["RANK"]),
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def is_writer() -> bool:
    """Whether this process writes an experiment's files: rank 0 of the
    default process group, or the only process."""
    return _world()[1] == 0


# ---------------------------------------------------------------------------
# collectives (all_reduce only); a group of None is this rank alone
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group, tag: str,
                average: bool = False) -> torch.Tensor:
    """Sums `t` over `group` in place (then divides by the group's size
    with `average`); counts the call as "collective_<tag>"."""
    if group is None:
        return t
    profiling.count("collective_" + tag)
    with profiling.span("collective." + tag, t.device):
        dist.all_reduce(t, group=group)
    if average:
        t.div_(dist.get_world_size(group))
    return t


def all_gather_rows(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    """The blocks of `x` (equal shapes on every rank) of the ranks of
    `group`, stacked along dim 0 in group-rank order: a zeroed buffer with
    this rank's block written in, summed over the group (bit-exact)."""
    if group is None:
        return x
    n, k = dist.get_world_size(group), dist.get_rank(group)
    if x.dtype == torch.bool:
        return all_gather_rows(x.to(torch.uint8), group, tag).bool()
    b = x.shape[0]
    out = x.new_zeros((n * b,) + tuple(x.shape[1:]))
    out[k * b:(k + 1) * b] = x
    return all_reduce_(out, group, tag)


def barrier(group=None) -> None:
    """Waits for every rank of `group` (default: all ranks): a one-element
    all_reduce on the backend's device. No-op without a process group."""
    world, _ = _world()
    if world == 1:
        return
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    profiling.count("collective_barrier")
    with profiling.span("collective.barrier", dev):
        dist.all_reduce(torch.zeros(1, device=dev), group=group)


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group, reduce_grad, tag):
        ctx.group, ctx.reduce_grad, ctx.rows = group, reduce_grad, x.shape[0]
        return all_gather_rows(x.contiguous(), group, tag)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = all_reduce_(g.contiguous().clone(), ctx.group,
                            "gather_rows_grad")
        k = group_rank(ctx.group)
        return g[k * ctx.rows:(k + 1) * ctx.rows], None, None, None


def gather_rows(x: torch.Tensor, group, *, reduce_grad: bool,
                tag: str = "gather_rows") -> torch.Tensor:
    """``all_gather_rows`` with a gradient. `reduce_grad`: every rank's
    loss reads other ranks' rows, so a row's gradient is the sum over the
    group (then kept by the rank that owns the row); without it the
    downstream computation is the same on every rank of the group and
    each rank keeps its block of its own gradient."""
    if group is None:
        return x
    return _GatherRows.apply(x, group, reduce_grad, tag)


class _CopyToGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group,
                           "copy_to_group_grad"), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over `group` backward (the
    input of a tensor-parallel layer, replicated over its group)."""
    if group is None:
        return x
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group, "reduce_from_group")

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` forward; identity backward (the partial outputs of
    a row-parallel layer)."""
    if group is None:
        return x
    return _ReduceFromGroup.apply(x, group)


def all_reduce_grads_(params: Iterable[torch.Tensor], group, *,
                      average: bool, tag: str = "grads") -> None:
    """Sums (or averages) the gradients of `params` over `group`, one
    all_reduce per dtype over a flat buffer."""
    if group is None:
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce_(flat, group, tag, average=average)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view(g.shape))
            off += g.numel()


# ---------------------------------------------------------------------------
# batch sharding
# ---------------------------------------------------------------------------

def shard_rows(x, mesh: Optional[Mesh], what: str = "batch"):
    """This rank's block of `x` (a tensor or array) along dim 0 over the
    mesh's 'data' axis: the counterpart of ``batch_sharding``. Raises when
    the rows do not divide over the data shards."""
    if mesh is None or mesh.n_data == 1:
        return x
    n = x.shape[0]
    if n % mesh.n_data:
        raise ValueError(f"{what} of {n} rows must divide evenly over the "
                         f"mesh's {mesh.n_data} 'data' shards")
    b = n // mesh.n_data
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def shard_height(x, mesh: Optional[Mesh]):
    """This rank's block of the H axis (dim 1) of an NHWC image batch `x`
    (a tensor or array) over the mesh's 'model' axis: the H half of JAX's
    ``P("data", "model")``. Raises when the rows do not divide over the
    model shards."""
    if mesh is None or mesh.n_model == 1:
        return x
    n = x.shape[1]
    if n % mesh.n_model:
        raise ValueError(f"an image height of {n} rows must divide evenly "
                         f"over the mesh's {mesh.n_model} 'model' shards")
    h = n // mesh.n_model
    return x[:, mesh.model_index * h:(mesh.model_index + 1) * h]


def check_batch_divides(batch_size: int, mesh: Optional[Mesh]) -> None:
    """The JAX trainers' error for a batch that does not shard evenly."""
    if mesh is not None and batch_size % mesh.n_data:
        raise ValueError(
            f"batch_size {batch_size} must divide evenly over the mesh's "
            f"{mesh.n_data} 'data' shards")


def global_step_outputs(mesh: Optional[Mesh], loss, e_pos, e_neg):
    """An edge step's summed loss and its energies over the global batch:
    the loss summed over 'data', the energies gathered in row order."""
    if mesh is None:
        return loss, e_pos, e_neg
    g = mesh.data_group
    return (all_reduce_(loss.clone(), g, "loss"),
            all_gather_rows(e_pos, g, "energies"),
            all_gather_rows(e_neg, g, "energies"))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSharding:
    """A parameter's place on the mesh: its JAX path, the JAX
    PartitionSpec over the JAX shape's axes, and the torch dim that shards
    over 'model' (None: replicated)."""
    jax_path: str
    spec: Tuple[Optional[str], ...]
    dim: Optional[int]


def param_shardings(model: nn.Module, mesh,
                    tp_patterns: Sequence[str] = ()
                    ) -> Dict[str, ParamSharding]:
    """The JAX package's rule for each parameter of `model`: replicated,
    except parameters whose JAX path ('/'-joined) matches one of
    `tp_patterns` (regex search); those shard over 'model' on the last JAX
    axis whose size divides the 'model' axis: column-parallel when the
    fan-out divides, else row-parallel on the fan-in; replicated if
    neither divides. `mesh` needs only a ``shape`` mapping."""
    from ..models.jax_import import jax_param_path

    compiled = [re.compile(p) for p in tp_patterns]
    n_model = dict(mesh.shape).get("model", 1)
    out = {}
    for name, _ in model.named_parameters():
        path, shape, to_torch = jax_param_path(model, name)
        spec: list = [None] * len(shape)
        dim = None
        if (n_model > 1 and len(shape) >= 1
                and any(p.search(path) for p in compiled)):
            for axis in range(len(shape) - 1, -1, -1):
                if shape[axis] % n_model == 0:
                    spec[axis] = "model"
                    dim = to_torch[axis]
                    break
        out[name] = ParamSharding(path, tuple(spec), dim)
    return out


class ShardedLinear(nn.Module):
    """A linear layer whose weight (out, in) shards over the mesh's 'model'
    group along `dim`: 0 (column-parallel: each rank computes its block of
    the outputs, gathered) or 1 (row-parallel: each rank multiplies its
    block of the inputs, the partial outputs summed). The bias stays
    replicated. The input is replicated over the group, so its gradient is
    summed over the group on the way back."""

    def __init__(self, full: nn.Linear, mesh: Mesh, dim: int):
        super().__init__()
        if dim not in (0, 1):
            raise ValueError(f"a linear weight shards on dim 0 or 1, not "
                             f"{dim}")
        self.out_features, self.in_features = full.weight.shape
        self.dim = dim
        self.group = mesh.model_group
        self.parts, self.index = mesh.n_model, mesh.model_index
        with torch.no_grad():
            self.weight = nn.Parameter(self.shard(full.weight).clone())
            self.bias = (None if full.bias is None
                         else nn.Parameter(full.bias.detach().clone()))

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a tensor shaped like the full weight."""
        return full.detach().chunk(self.parts, self.dim)[self.index]

    def gather(self, block: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (no gradient)."""
        moved = block.detach().movedim(self.dim, 0).contiguous()
        return all_gather_rows(moved, self.group, "gather_weight").movedim(
            0, self.dim).contiguous()

    def forward(self, x):
        x = copy_to_group(x, self.group)
        if self.dim == 0:
            z = F.linear(x, self.weight)                 # (B, out / p)
            z = gather_rows(z.T, self.group, reduce_grad=False,
                            tag="gather_cols").T
        else:
            xs = x.chunk(self.parts, -1)[self.index]
            z = reduce_from_group(F.linear(xs, self.weight), self.group)
        return z if self.bias is None else z + self.bias

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, dim={self.dim}, parts={self.parts}")


def shard_linear_layers_(model: nn.Module, mesh: Mesh,
                         shardings: Dict[str, ParamSharding]) -> list:
    """Replaces each linear layer whose weight `shardings` shards by a
    ``ShardedLinear``; returns the replaced layers' names. Raises for a
    sharded parameter that is not a linear layer's weight: tensor
    parallelism is written out for linear layers only."""
    names = []
    for name, sh in shardings.items():
        if sh.dim is None:
            continue
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        if not isinstance(module, nn.Linear) or leaf != "weight":
            raise NotImplementedError(
                f"{name} ({sh.jax_path}) would shard over 'model', but "
                f"tensor parallelism is written out for linear layers' "
                f"weights only")
        parent, _, attr = owner.rpartition(".")
        setattr(model.get_submodule(parent) if parent else model, attr,
                ShardedLinear(module, mesh, sh.dim))
        names.append(owner)
    return names
