"""Data and tensor parallelism over ``torch.distributed`` (counterpart of
``mintime_tpu/parallel/mesh.py``).

One process a card (``torchrun --nproc_per_node N``), or a ``gloo`` group of
CPU processes. :func:`make_mesh` joins the process group from the
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as
``torchrun`` sets them: NCCL on the card, gloo on the CPU; a failed init
raises) and returns a ``DeviceMesh`` of dims ``("data", "model")``.

* ``data``: every rank iterates the same global batches and takes its
  contiguous rows of each (:func:`shard_rows`, :func:`shard_batch`: the rows
  ``P("data")`` gives device ``r``); a training batch of fewer rows than
  ranks is padded with cyclic repeats marked ``valid`` 0 (:func:`pad_rows`). :func:`data_parallel` wraps a model in
  ``DistributedDataParallel`` over the data group and syncs its BatchNorm
  statistics over the global batch, as the JAX mesh takes them; the train
  and eval steps (:mod:`mintime_torch.train`) weigh each rank's loss so that
  the ranks together compute the global batch's mean, unequal last batches
  included.
* ``model``: Megatron tensor parallelism of the TimeSformer head
  (:func:`tensor_parallel`, the rule of :func:`state_shardings`):
  ``to_qkv`` and the GEGLU's ``net.0`` column-parallel (split by heads, and
  by hidden units within both the value and the gate halves), ``to_out.0``
  and ``net.3`` row-parallel with one all-reduce over the model group after
  each; the extractor and everything else replicated.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(model_parallel: int = 1, device: str | torch.device = "cuda"):
    """A ``(data, model)`` DeviceMesh over every process of the group,
    ``model_parallel`` consecutive ranks a model group. The process group is
    initialised from the environment when it is not yet: NCCL for the card,
    each process on its ``LOCAL_RANK``'s card, gloo for the CPU. A caller
    that wants another backend initialises the group first."""
    from torch.distributed.device_mesh import init_device_mesh

    from mintime_torch.device import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(card)
            dist.init_process_group("nccl", init_method="env://", device_id=card)
        else:
            dist.init_process_group("gloo", init_method="env://")
    world = dist.get_world_size()
    if world % model_parallel:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    return init_device_mesh(dev.type, (world // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def launch_mesh(device: str | torch.device = "cuda"):
    """The data-parallel mesh of a ``torchrun`` launch (``WORLD_SIZE`` in the
    environment), else None (one process): what the CLIs train, score and
    pretrain over."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return make_mesh(device=device)


def axis_size(mesh, axis: str = DATA_AXIS) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str = DATA_AXIS) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def is_main(mesh) -> bool:
    """Whether this process writes what one process writes (rank 0)."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier()


def shard_rows(n: int, rank: int, world: int) -> slice:
    """The contiguous rows ``[rank·n/W, (rank+1)·n/W)`` of ``n`` (floored),
    which data rank ``rank`` of ``world`` takes; unequal when ``world`` does
    not divide ``n``."""
    return slice(n * rank // world, n * (rank + 1) // world)


def batch_sharding(mesh):
    """This rank's rows of a batch as a function of its size: a callable
    ``n → slice`` (None without a mesh), the counterpart of the JAX
    ``NamedSharding(mesh, P("data"))``."""
    if mesh is None:
        return None
    rank, world = axis_rank(mesh), axis_size(mesh)
    return lambda n: shard_rows(n, rank, world)


def pad_rows(n: int, world: int) -> np.ndarray:
    """Rows of a global batch of ``n`` rows that gives each of ``world`` data
    ranks at least one: ``arange(n)`` where ``n >= world``, else the ``n``
    rows repeated cyclically to the least multiple of ``n`` that is at least
    ``world`` (the JAX loader pads a partial batch with cyclic repeats too).
    Each row then comes equally often, so a train-mode BatchNorm takes the
    statistics of the ``n`` rows, and drop-connect repeats its masks with
    the rows (:class:`~mintime_torch.models.efficientnet.BatchRows`)."""
    if n == 0 or n >= world:
        return np.arange(n)
    return np.resize(np.arange(n), -(-world // n) * n)


def pad_batch(mesh, batch: Mapping[str, Any]) -> dict:
    """A global batch dict padded by :func:`pad_rows` for the mesh's data
    ranks, with ``valid`` 1 on its own rows and 0 on the repeats; the batch
    itself where it needs no pad."""
    n = len(batch["labels"])
    rows = pad_rows(n, axis_size(mesh))
    if len(rows) == n:
        return dict(batch)
    out = {k: v[rows] if isinstance(v, (np.ndarray, torch.Tensor)) and len(v) == n
           else [v[i] for i in rows] if isinstance(v, list) and len(v) == n else v
           for k, v in batch.items()}
    out["valid"] = (np.arange(len(rows)) < n).astype(np.float32)
    return out


def shard_batch(mesh, batch: Mapping[str, Any]) -> dict:
    """This data rank's rows of a global batch dict: every value with a
    leading batch axis (arrays, tensors, lists) sliced the same way."""
    if mesh is None:
        return dict(batch)
    n = len(batch["labels"])
    rows = batch_sharding(mesh)(n)
    return {k: v[rows] if isinstance(v, (np.ndarray, torch.Tensor, list)) and len(v) == n else v
            for k, v in batch.items()}


def replicated(mesh, module: nn.Module) -> nn.Module:
    """``module``'s parameters and buffers broadcast from the first data rank,
    so that every data rank holds the same values."""
    if axis_size(mesh) > 1:
        group = mesh.get_group(DATA_AXIS)
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=src, group=group)
    return module


def all_sum(mesh, values: torch.Tensor) -> torch.Tensor:
    """The sum of ``values`` over the data ranks (no gradient)."""
    if axis_size(mesh) > 1:
        values = values.detach().clone()
        dist.all_reduce(values, group=mesh.get_group(DATA_AXIS))
    return values


def gather_rows(mesh, rows: list) -> list:
    """Every data rank's list of per-batch items, merged batch by batch in
    rank order: the global batches' rows in their original order (each item
    a numpy array or a list)."""
    if axis_size(mesh) == 1:
        return rows
    parts: list = [None] * axis_size(mesh)
    dist.all_gather_object(parts, rows, group=mesh.get_group(DATA_AXIS))
    out = []
    for batch in zip(*parts):
        if isinstance(batch[0], np.ndarray):
            out.append(np.concatenate(batch))
        else:
            out.append([x for part in batch for x in part])
    return out


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

def data_parallel(model: nn.Module, mesh) -> nn.Module:
    """``model`` in ``DistributedDataParallel`` over the data group, its
    BatchNorm layers (EfficientNet's, Xception's, SlowFast's) set to take
    train-mode statistics over the global batch through a group of their own
    (so their all-reduces never interleave with DDP's). With one data rank,
    the model itself."""
    from torch.nn.parallel import DistributedDataParallel

    from mintime_torch.models.efficientnet import BatchNorm

    if axis_size(mesh) == 1:
        return model
    group = mesh.get_group(DATA_AXIS)
    # every process enumerates every data group (one a model rank), as new groups need
    bn_group, _ = dist.new_subgroups_by_enumeration(mesh.mesh.T.tolist())
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.sync_group = bn_group
    dev = next(model.parameters()).device
    # params that a step leaves without a gradient: the last layer's token
    # FFN (only the CLS stream reaches the logits), a frozen backbone
    return DistributedDataParallel(model, device_ids=[dev.index] if dev.type == "cuda" else None,
                                   process_group=group, broadcast_buffers=False,
                                   find_unused_parameters=True)


# ---------------------------------------------------------------------------
# Tensor parallelism (Megatron) over the ``model`` axis
# ---------------------------------------------------------------------------

#: (parameter name suffix, rule): the JAX ``_TP_RULES`` in the port's names
_TP_RULES: tuple[tuple[str, str], ...] = (
    ("fn.to_qkv.weight", "column"),
    ("fn.to_out.0.weight", "row"),
    ("fn.to_out.0.bias", "replicated"),
    ("fn.net.0.weight", "column"),
    ("fn.net.0.bias", "column"),
    ("fn.net.3.weight", "row"),
    ("fn.net.3.bias", "replicated"),
)


def _tp_spec(name: str) -> str:
    """``"column"`` (output features split), ``"row"`` (input features
    split) or ``"replicated"`` for a parameter of the TimeSformer head."""
    if not name.startswith("head.layers."):
        return "replicated"
    for suffix, spec in _TP_RULES:
        if name.endswith(suffix):
            return spec
    return "replicated"


def state_shardings(model: nn.Module, mesh=None) -> dict[str, str]:
    """The tensor-parallel rule of every parameter of ``model`` by name."""
    return {name: _tp_spec(name) for name, _ in model.named_parameters()}


def _model_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the model group, added in fp32 at least and
    rounded once to ``x``'s dtype."""
    s = x.to(torch.promote_types(x.dtype, torch.float32)).contiguous()
    dist.all_reduce(s, group=group)
    return s.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _model_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _heads_rows(H: int, dh: int, tp: int, rank: int) -> torch.Tensor:
    """Rows of the ``[q | k | v]``-major ``to_qkv`` weight that model rank
    ``rank`` keeps: its heads' rows in each of q, k and v."""
    h = H // tp
    inner = H * dh
    local = torch.arange(rank * h * dh, (rank + 1) * h * dh)
    return torch.cat([local + part * inner for part in range(3)])


def _halves_rows(hidden: int, tp: int, rank: int) -> torch.Tensor:
    """Rows of the GEGLU's ``net.0`` (``[value | gate]``) that model rank
    ``rank`` keeps: its hidden units in both halves."""
    h = hidden // tp
    local = torch.arange(rank * h, (rank + 1) * h)
    return torch.cat([local, local + hidden])


class ColumnParallelLinear(nn.Module):
    """The rows ``rows`` of a Linear's weight (and bias): its output
    features of this model rank, the input passed through Megatron's f."""

    def __init__(self, full: nn.Linear, rows: torch.Tensor, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(full.weight.detach()[rows].clone())
        self.bias = (None if full.bias is None
                     else nn.Parameter(full.bias.detach()[rows].clone()))

    def forward(self, x):
        return nn.functional.linear(_CopyToModel.apply(x, self.group), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """The columns ``cols`` of a Linear's weight: its input features of this
    model rank; the partial products all-reduced over the model group, then
    the whole bias added once."""

    def __init__(self, full: nn.Linear, cols: torch.Tensor, group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(full.weight.detach()[:, cols].clone())
        self.bias = None if full.bias is None else nn.Parameter(full.bias.detach().clone())

    def forward(self, x):
        y = _ReduceFromModel.apply(nn.functional.linear(x, self.weight), self.group)
        return y if self.bias is None else y + self.bias


class TensorParallelGEGLU(nn.Module):
    """The GEGLU FFN with ``net.0`` column-parallel and ``net.3``
    row-parallel: the fused kernel (or the plain path) over this rank's
    hidden units with no output bias, one all-reduce, then ``net.3``'s bias."""

    def __init__(self, ff: nn.Module, tp: int, rank: int, group):
        super().__init__()
        l0, l1 = ff.net["0"], ff.net["3"]
        hidden = l1.weight.shape[1]
        if hidden % tp:
            raise ValueError(f"hidden {hidden} does not divide over {tp} model ranks")
        rows = _halves_rows(hidden, tp, rank)
        cols = torch.arange(rank * hidden // tp, (rank + 1) * hidden // tp)
        self.use_kernels, self.group = ff.use_kernels, group
        self.net = nn.ModuleDict({
            "0": nn.Linear(l0.in_features, 2 * hidden // tp, device=l0.weight.device,
                           dtype=l0.weight.dtype),
            "2": ff.net["2"],
            "3": nn.Linear(hidden // tp, l1.out_features, device=l1.weight.device,
                           dtype=l1.weight.dtype)})
        with torch.no_grad():
            self.net["0"].weight.copy_(l0.weight[rows])
            self.net["0"].bias.copy_(l0.bias[rows])
            self.net["3"].weight.copy_(l1.weight[:, cols])
            self.net["3"].bias.copy_(l1.bias)

    def forward(self, x):
        from mintime_torch.ops.geglu_ffn import geglu_ffn

        l0, drop, l1 = self.net["0"], self.net["2"], self.net["3"]
        x = _CopyToModel.apply(x, self.group)
        if self.use_kernels and (drop.p == 0.0 or not self.training):
            # the kernel adds its b1 itself: zeros here, the bias after the reduce
            y = geglu_ffn(x, l0.weight, l0.bias, l1.weight, torch.zeros_like(l1.bias))
        else:
            val, gates = l0(x).chunk(2, dim=-1)
            y = nn.functional.linear(drop(val * nn.functional.gelu(gates)), l1.weight)
        return _ReduceFromModel.apply(y, self.group) + l1.bias


def tensor_parallel(model: nn.Module, mesh) -> nn.Module:
    """Convert a built model (the same weights on every rank) in place to
    this model rank's shard of its TimeSformer head: each divided attention
    keeps ``heads / tp`` heads (their q, k and v rows of ``to_qkv``, their
    columns of ``to_out.0``), each GEGLU ``hidden / tp`` units of both
    halves of ``net.0`` and their columns of ``net.3``. Everything else stays
    replicated. Build the optimizer after this. With one model rank, the
    model unchanged."""
    from mintime_torch.models.timesformer import GEGLU, DividedAttention

    tp = axis_size(mesh, MODEL_AXIS)
    if tp == 1:
        return model
    rank, group = axis_rank(mesh, MODEL_AXIS), mesh.get_group(MODEL_AXIS)
    whole = {n: p.shape for n, p in model.named_parameters()}
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, DividedAttention):
                H, dh = child.heads, child.dim_head
                if H % tp:
                    raise ValueError(f"{H} heads do not divide over {tp} model ranks")
                child.to_qkv = ColumnParallelLinear(child.to_qkv, _heads_rows(H, dh, tp, rank),
                                                    group)
                cols = torch.arange(rank * H // tp * dh, (rank + 1) * H // tp * dh)
                child.to_out["0"] = RowParallelLinear(child.to_out["0"], cols, group)
                child.heads = H // tp
            elif isinstance(child, GEGLU):
                setattr(parent, name, TensorParallelGEGLU(child, tp, rank, group))
    if hasattr(model, "_cast_names"):  # CastModel: the parameters a forward casts
        from mintime_torch.models.classifier import _cast_names

        model._cast_names = {c: _cast_names(getattr(model, c)) for c in model._cast_names}
    # the shards are what the rule says: a tp-th of the split axis, the rest whole
    for name, p in model.named_parameters():
        want = list(whole[name])
        split = {"column": 0, "row": 1}.get(_tp_spec(name))
        if split is not None:
            want[split] //= tp
        if list(p.shape) != want:
            raise AssertionError(f"tensor_parallel: {name} is {tuple(p.shape)}, the rule "
                                 f"{_tp_spec(name)!r} wants {tuple(want)}")
    return model
