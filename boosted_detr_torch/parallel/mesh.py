"""The ('data', 'model') mesh over the processes of a ``torch.distributed``
run, batch placement, and the collectives the model and the steps use.

Counterpart of boosted_detr_tpu/parallel/mesh.py. There a mesh is an
array of devices and XLA inserts the collectives that GSPMD needs; here
one process owns one device, so a mesh is an arrangement of ranks: rank
``r`` sits at ``data = r // model``, ``model = r % model`` (JAX's
``devices.reshape(data, model)``), and ``make_mesh`` builds the process
groups of both axes. Without a process group the world is one rank and
every collective below is the identity.

JAX's arrays under pjit are global, so every reduction over the batch is
global. The port's tensors are this rank's rows, and the places that
reduce over the batch ask the *active* mesh (``with mesh:``, which the
train and eval steps and the Trainer's loop enter) for its data axis:
BatchNorm's statistics (``all_reduce_sum``), the loss normalisers
(``data_sum``), the random draws (``draw_global``: the global batch's
bits, this rank's rows) and the step's metrics (``global_metrics``).

Every collective here is an ``all_reduce`` (SUM or MAX) or a
``broadcast``: the two that gloo runs on CUDA tensors as well as on CPU
ones, so that two ranks may share one card over gloo.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
_AXES = (DATA_AXIS, MODEL_AXIS)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(eq=False)
class Mesh:
    """``shape`` ({"data": D, "model": M}, as JAX's ``mesh.shape``), this
    rank's coordinates, the process group of each axis (None for an axis
    of size 1) and this rank's device. ``with mesh:`` makes it the active
    mesh of the code inside."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    device: torch.device

    @property
    def rank(self) -> int:
        return self.coords[DATA_AXIS] * self.shape[MODEL_AXIS] \
            + self.coords[MODEL_AXIS]

    @property
    def world(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[MODEL_AXIS]

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.pop()


_ACTIVE: List[Mesh] = []
# the groups of each (default group, data, model): new_group is collective,
# so every rank makes them once, in the same order
_GROUPS: Dict[Tuple, Tuple[Dict[str, Optional[dist.ProcessGroup]], ...]] = {}


def _axis_groups(data: int, model: int) -> Tuple[Dict, ...]:
    """Per rank, the group of its data axis (the ranks with its model
    coordinate) and of its model axis (the ranks with its data
    coordinate); an axis of size 1 has none."""
    key = (dist.group.WORLD if dist.is_initialized() else None, data, model)
    if key not in _GROUPS:
        per_rank = [dict.fromkeys(_AXES) for _ in range(data * model)]
        if model > 1:
            for d in range(data):
                ranks = [d * model + m for m in range(model)]
                group = dist.new_group(ranks)
                for r in ranks:
                    per_rank[r][MODEL_AXIS] = group
        if data > 1:
            for m in range(model):
                ranks = [d * model + m for d in range(data)]
                group = dist.new_group(ranks)
                for r in ranks:
                    per_rank[r][DATA_AXIS] = group
        _GROUPS[key] = tuple(per_rank)
    return _GROUPS[key]


def make_mesh(shape: Optional[Dict[str, int]] = None, device=None) -> Mesh:
    """A ('data', 'model') mesh over the ranks of the process group (one
    rank without one). Default: every rank on 'data'. Raises
    ``ValueError`` when data * model is not the number of ranks.
    ``device`` is this rank's (``cuda`` unless the caller passes
    another)."""
    from boosted_detr_torch.models.detr import _resolve_device

    n = world_size()
    if shape is None:
        shape = {DATA_AXIS: n, MODEL_AXIS: 1}
    data = shape.get(DATA_AXIS, 1)
    model = shape.get(MODEL_AXIS, 1)
    if data * model != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    rank = world_rank()
    return Mesh(shape={DATA_AXIS: data, MODEL_AXIS: model},
                coords={DATA_AXIS: rank // model, MODEL_AXIS: rank % model},
                groups=dict(_axis_groups(data, model)[rank]),
                device=_resolve_device(device))


def active() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def axis_of(axis: str, mesh: Optional[Mesh] = None
            ) -> Optional[Tuple[int, int, dist.ProcessGroup]]:
    """(this rank's index, size, group) of ``axis`` of ``mesh`` (the
    active one when None), or None where it has one rank."""
    mesh = mesh if mesh is not None else active()
    if mesh is None or mesh.shape[axis] == 1:
        return None
    return mesh.coords[axis], mesh.shape[axis], mesh.groups[axis]


def data_shard() -> Optional[Tuple[int, int, dist.ProcessGroup]]:
    """``axis_of(DATA_AXIS)`` of the active mesh."""
    return axis_of(DATA_AXIS)


# -- placement ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatchSharding:
    """The leading (batch) axis split over 'data', the rest replicated:
    the rank at data coordinate d holds rows [d n/D, (d+1) n/D)."""

    mesh: Mesh

    def rows(self, n: int) -> slice:
        d, size = self.mesh.coords[DATA_AXIS], self.mesh.shape[DATA_AXIS]
        if n % size:
            raise ValueError(f"a batch of {n} rows does not split over the "
                             f"'data' axis ({size})")
        per = n // size
        return slice(d * per, (d + 1) * per)


@dataclasses.dataclass(frozen=True)
class Replicated:
    """Every rank holds the whole value."""

    mesh: Mesh


def batch_sharding(mesh: Mesh) -> BatchSharding:
    return BatchSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


class ShardedBatch(dict):
    """A batch dict of this rank's rows, with ``global_size``, the rows of
    the global batch it is a shard of."""

    def __init__(self, entries, global_size: int):
        super().__init__(entries)
        self.global_size = int(global_size)


def to_device(value, device: torch.device):
    """A numeric numpy array or a tensor as a tensor on ``device``;
    anything else (an array of paths) as it is."""
    if isinstance(value, np.ndarray):
        if value.dtype.kind not in "biuf":
            return value
        value = torch.from_numpy(np.ascontiguousarray(value))
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return value


def shard_batch(batch, mesh: Mesh) -> ShardedBatch:
    """This rank's rows of a global batch dict (numpy arrays or tensors),
    as tensors on the mesh's device."""
    sharding = batch_sharding(mesh)
    n = len(next(iter(batch.values())))
    rows = sharding.rows(n)
    return ShardedBatch({k: to_device(v[rows], mesh.device)
                         for k, v in batch.items()}, n)


# -- collectives --------------------------------------------------------


def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM
                ) -> torch.Tensor:
    """A reduced copy of ``t``; bf16 and fp16 values are reduced in
    float32 and rounded back once."""
    low = t.dtype in (torch.bfloat16, torch.float16)
    out = t.float() if low else t.clone()
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.dtype) if low else out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` forward and backward: a value every rank
    computes from all ranks' parts, whose uses on each rank are that
    rank's alone (BatchNorm's statistics under data parallelism)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumForward(torch.autograd.Function):
    """Sum over ``group`` forward, identity backward: a partial sum whose
    result every rank uses alike (a row-split layer's output, the merge of
    context-parallel shards), so each rank's cotangent is already the
    whole one."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity forward, sum over ``group`` backward: a replicated input
    that each rank uses for its part only (the input of a column-split
    layer, context parallelism's q)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group``; the backward sums too."""
    return x if group is None else _AllReduceSum.apply(x, group)


def sum_forward(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumForward.apply(x, group)


def sum_backward(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumBackward.apply(x, group)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, not differentiated."""
    return x if group is None else _all_reduce(x.detach(), group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Element-wise max over ``group``, not differentiated."""
    return x if group is None else _all_reduce(x.detach(), group,
                                               dist.ReduceOp.MAX)


def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum()`` over the global batch in float32 (a normaliser such as
    ``sum(num_objects)``), not differentiated."""
    shard = data_shard()
    return reduce_sum(x.detach().float().sum(),
                      shard[2] if shard is not None else None)


def draw_global(draw: Callable[[Tuple[int, ...]], torch.Tensor],
                shape: Sequence[int]) -> torch.Tensor:
    """``draw(shape)`` for this rank's rows of the global batch: the draw
    is made at the global batch's shape and this rank keeps its rows, so
    that N ranks of B/N rows draw what one rank of B rows draws, as JAX
    draws on a global array."""
    shard = data_shard()
    if shard is None:
        return draw(tuple(shape))
    index, size, _ = shard
    b = shape[0]
    return draw((b * size, *shape[1:]))[index * b:(index + 1) * b]


def global_metrics(aux: Dict[str, torch.Tensor],
                   mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """A step's scalar metrics over the global batch of ``mesh`` (the
    active one when None), in one all-reduce: ``loss`` and the ``loss_*``
    sums are summed over the data axis, the others (means over the batch:
    ``iou``, ``accuracy``) averaged, the shards being of one size."""
    shard = axis_of(DATA_AXIS, mesh)
    if shard is None:
        return aux
    _, size, group = shard
    keys = list(aux)
    packed = reduce_sum(torch.stack([aux[k].detach().float().reshape(())
                                     for k in keys]), group)
    return {k: (packed[i] if k.startswith("loss") else packed[i] / size)
            for i, k in enumerate(keys)}


BUCKET_BYTES = 32 << 20


def all_reduce_gradients(params: Sequence[torch.Tensor], group) -> int:
    """Sums the gradients of ``params`` over ``group`` in place, packed
    into flat buckets of at most ``BUCKET_BYTES`` (one all-reduce each,
    not one per tensor). Returns the bytes reduced."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return 0
    buckets: List[List[torch.Tensor]] = []
    filled: Dict[torch.dtype, Tuple[List[torch.Tensor], int]] = {}
    for g in grads:
        bucket, n_bytes = filled.get(g.dtype, (None, 0))
        size = g.numel() * g.element_size()
        if bucket is None or n_bytes + size > BUCKET_BYTES:
            bucket, n_bytes = [], 0
            buckets.append(bucket)
        bucket.append(g)
        filled[g.dtype] = (bucket, n_bytes + size)
    total = 0
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=group)
        total += flat.numel() * flat.element_size()
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
    return total


def barrier() -> None:
    """Waits for every rank; nothing without a process group."""
    if world_size() > 1:
        dist.barrier()
