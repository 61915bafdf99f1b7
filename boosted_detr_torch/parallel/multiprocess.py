"""Several processes, one device each, on ``torch.distributed``.

Counterpart of boosted_detr_tpu/parallel/multiprocess.py:

- ``initialize``: ``init_process_group`` with the coordinator's address,
  the number of processes and this one's rank, once (a second call does
  nothing). Every collective then waits at most ``timeout`` (60 s by
  default), so that a rank that is gone makes the others fail instead of
  hang;
- ``feed_info``: the (process_index, process_count) pair the data pipeline
  strides its rows by (``Pipeline.batches(process_index=,
  process_count=)``);
- ``global_batch``: a process's local batch as its shard of the global
  batch, on its device: under pjit JAX assembles a global array from the
  shards; here the shard stays where it is, and the mesh's collectives
  make every batch reduction global (parallel/mesh.py).

Launch (one command per process; ``batch_size`` is per process):

    python -m boosted_detr_torch.cli train --synthetic \\
        --coordinator host0:1234 --num-processes 2 --process-id $RANK
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import torch
import torch.distributed as dist

from boosted_detr_torch.parallel import mesh as mesh_lib

TIMEOUT = datetime.timedelta(seconds=60)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: Optional[str] = None,
               device=None) -> None:
    """``init_process_group`` at ``tcp://<coordinator_address>`` (an
    address with a scheme, such as ``file:///path``, is taken as it is),
    unless a process group exists already. ``backend=None`` is ``nccl``
    when ``device`` (``cuda`` unless the caller passes another) is a CUDA
    device and ``gloo`` otherwise; a ``backend`` the caller names is the
    one used. On a CUDA device the process takes card ``process_id``
    modulo the cards there are, unless ``device`` names one."""
    from boosted_detr_torch.models.detr import _resolve_device

    if dist.is_initialized():
        return
    device = _resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None
                              else process_id % torch.cuda.device_count())
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)


def feed_info() -> Dict[str, int]:
    """The stride this process reads from the dataset."""
    return {"process_index": mesh_lib.world_rank(),
            "process_count": mesh_lib.world_size()}


def global_batch(local_batch, sharding) -> mesh_lib.ShardedBatch:
    """This process's local batch dict (its rows of the global batch,
    from a strided feed) on its device, as the shard of ``sharding``
    (``mesh.batch_sharding(mesh)``), with the global batch's size: the
    local size times the 'data' axis."""
    if not isinstance(sharding, mesh_lib.BatchSharding):
        raise TypeError("global_batch takes mesh.batch_sharding(mesh), not "
                        f"{type(sharding).__name__}")
    mesh = sharding.mesh
    n = len(next(iter(local_batch.values())))
    return mesh_lib.ShardedBatch(
        {k: mesh_lib.to_device(v, mesh.device)
         for k, v in local_batch.items()},
        n * mesh.shape[mesh_lib.DATA_AXIS])
