"""Exact batched linear assignment (K2): the hand-written Hopper kernel and
its plain PyTorch version.

Counterpart of boosted_detr_tpu/ops/pallas_lap.py: ``hungarian_lap_pallas``
(:159-191) and its kernel ``_lap_kernel`` (:49-156). Contract: cost
[B, O, P] float32 (no gradient) and ``num_objects`` [B] int32 in; a 0/1
float32 mask [B, O, P] out, one 1 in each of the first ``num_objects[b]``
rows and zero on the other rows, at an assignment of least total cost.

The algorithm is the Jonker-Volgenant shortest augmenting path with dual
potentials u (rows) and v (columns), row after row. Columns are the P real
ones, then one private dummy column per row, then a virtual start column
(C = P + O + 1 in all). A dummy costs -BIG to its row when the row is
inactive (i >= n) and +BIG otherwise, so an inactive row takes its dummy
in one Dijkstra step and every problem runs the same loop structure.

``hungarian_lap_reference`` is the plain version: all B problems advance
in lockstep over [B, C] tensors with masks, as the TPU kernel's lanes do,
deterministically, with the lowest index winning a tie in the argmin
(``torch.min`` over a dim returns the first minimum, as ``jnp.argmin``
does). It is also the port's ``matcher="hungarian"`` solver.

The kernels, ``csrc/lap.cu``, are CUDA C++ for ``sm_90a``, one block a
problem, an argmin on ``redux.sync``. They take O <= 120 rows (the TPU
kernel's limit) and any P, on routes that ``kernel_plan`` chooses from the
shape: ``lap_kernel`` (the "slots" route, one warp solving) spreads the C
columns over the 32 lanes in a number of register slots fitted to C and
keeps the cost rows in shared memory, where C <= 1024 and the rows fit in
the 227 KB a block may use; ``lap_columns_kernel`` takes every other
shape, its 256 threads all taking part in every Dijkstra step and reading
the cost rows from L2: the column state in a number of register slots a
thread fitted to C ("columns", up to 4096 columns) or, past them, in a
scratch buffer the wrapper allocates ("columns_global"). All repeat the
plain version's float32 arithmetic operation for operation, so they give
its mask, ties included.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_INF = 1e30
_BIG = 1e9
WARP = 32
THREADS = 256  # the slots route's block of one problem
# The kernel's limits, as csrc/lap.cu states them: the rows it takes (4
# row slots a lane), the columns a lane may hold on the slots route (it
# takes the fewest that hold C), and the most shared memory one thread
# block may use on an H100; the columns route's threads a block and the
# column slots a thread may hold in registers (the fewest that hold C).
MAX_OBJECTS = 120
SLOT_CHOICES = (5, 8, 12, 16, 24, 32)
SMEM_LIMIT = 232448
COLUMN_THREADS = 256
COLUMN_SLOT_CHOICES = (3, 4, 6, 8, 10, 12, 16)


class LapPlan(NamedTuple):
    """How the kernels solve a problem of O rows and P columns."""
    route: str  # "slots", "columns" or "columns_global"
    slots: int  # columns a lane (slots) or a thread (columns) holds, else 0
    smem: int   # dynamic shared memory of one problem's block, in bytes
    scratch: int  # device-memory bytes of one problem's column state
    threads: int  # the block of one problem


def columns_bytes(o: int, p: int) -> int:
    """One problem's column state in device memory past the columns
    route's register slots (``lap.cu``'s ``columns_bytes``): 17 bytes a
    column, rounded up to 16."""
    return (17 * (p + o + 1) + 15) // 16 * 16


def kernel_plan(o: int, p: int) -> LapPlan:
    """The kernels' plan for O rows and P columns: the slots route where
    C = P + O + 1 <= 1024 and the cost rows fit beside two ints a column
    slot in shared memory, else the columns route, its column state in
    registers up to 16 slots a thread, past that in device memory. Raises
    ValueError, naming the limit, for O > 120, the TPU kernel's own
    limit."""
    if o < 1 or p < 1:
        raise ValueError(f"hungarian_lap: O={o} and P={p} must be positive")
    if o > MAX_OBJECTS:
        raise ValueError(f"hungarian_lap: the kernel takes O <= "
                         f"{MAX_OBJECTS} rows, got O={o}")
    columns = p + o + 1
    slots = next((s for s in SLOT_CHOICES if columns <= WARP * s), 0)
    smem = 4 * (o * p + 2 * WARP * slots)
    if slots and smem <= SMEM_LIMIT:
        return LapPlan("slots", slots, smem, 0, THREADS)
    k = next((s for s in COLUMN_SLOT_CHOICES
              if columns <= COLUMN_THREADS * s), 0)
    if k:
        return LapPlan("columns", k, 0, 0, COLUMN_THREADS)
    return LapPlan("columns_global", 0, 0, columns_bytes(o, p),
                   COLUMN_THREADS)


def kernel_name(o: int, p: int) -> str:
    """The device kernel ``hungarian_lap`` launches for O rows and P
    columns, as a profile names it (``lap.cu``'s dispatch: the slots
    route's row slots R = 1 up to 32 rows, else 4; the columns route's
    register slots, 0 for the column state in device memory)."""
    plan = kernel_plan(o, p)
    if plan.route == "slots":
        return f"lap_kernel<{plan.slots}, {1 if o <= WARP else 4}>"
    return f"lap_columns_kernel<{plan.slots}>"


def _check(cost: torch.Tensor, num_objects: torch.Tensor):
    if cost.dim() != 3:
        raise ValueError(f"cost must be [B, O, P], got {tuple(cost.shape)}")
    if num_objects.shape != (cost.shape[0],):
        raise ValueError(f"num_objects must be [B] = [{cost.shape[0]}], got "
                         f"{tuple(num_objects.shape)}")


def hungarian_lap_reference(cost: torch.Tensor, num_objects: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version: exact assignment mask [B, O, P] float32."""
    _check(cost, num_objects)
    cost = cost.detach().float()
    b, o, p = cost.shape
    dev = cost.device
    c = p + o + 1
    virt = c - 1
    free = o  # the row id of an unmatched column
    n = num_objects.reshape(b).to(device=dev, dtype=torch.long)
    lanes = torch.arange(b, device=dev)
    col_ids = torch.arange(c, device=dev)
    row_ids = torch.arange(o, device=dev)

    # [B, O, C]: real costs, the dummy columns, BIG at the virtual column
    inactive = row_ids[None, :] >= n[:, None]  # [B, O]
    dummy = torch.full((b, o, o), _BIG, device=dev)
    dummy[:, row_ids, row_ids] = torch.where(inactive, -_BIG, _BIG)
    cost_aug = torch.cat([cost, dummy, torch.full((b, o, 1), _BIG,
                                                  device=dev)], dim=2)

    u = torch.zeros((b, o), device=dev)
    v = torch.zeros((b, c), device=dev)
    match = torch.full((b, c), free, dtype=torch.long, device=dev)
    for i in range(o):
        match[:, virt] = i
        minv = torch.full((b, c), _INF, device=dev)
        way = torch.full((b, c), virt, dtype=torch.long, device=dev)
        used = torch.zeros((b, c), dtype=torch.bool, device=dev)
        j0 = torch.full((b,), virt, dtype=torch.long, device=dev)
        # Each step marks a new column used, so a search ends within C
        # steps; the cap only stops a loop on NaN costs.
        for _ in range(c):
            i0 = match[lanes, j0]
            active = i0 != free
            n_active = int(active.sum())
            if n_active == 0:
                break
            hungarian_lap_reference.relaxations += n_active
            i0c = i0.clamp(max=o - 1)
            used = used | ((col_ids[None, :] == j0[:, None]) & active[:, None])
            reduced = cost_aug[lanes, i0c] - u[lanes, i0c][:, None] - v
            avail = ~used
            better = (reduced < minv) & avail & active[:, None]
            minv = torch.where(better, reduced, minv)
            way = torch.where(better, j0[:, None], way)
            masked = torch.where(avail, minv, torch.full_like(minv, _INF))
            delta, j1 = masked.min(dim=1)
            delta = torch.where(active, delta, torch.zeros_like(delta))
            # rows owning used columns gain delta (the current row i owns
            # the virtual column), used columns lose it, the tentative
            # distances of the others shrink by it
            hit = used & active[:, None]
            owners = torch.where(hit, match, torch.full_like(match, free))
            gain = torch.zeros((b, o + 1), device=dev)
            gain.scatter_(1, owners, hit.float())
            u = torch.where(gain[:, :o] > 0, u + delta[:, None], u)
            v = torch.where(hit, v - delta[:, None], v)
            minv = torch.where(avail & active[:, None], minv - delta[:, None],
                               minv)
            j0 = torch.where(active, j1, j0)
        # augment along ``way`` back to the virtual column
        for _ in range(c):
            active = j0 != virt
            if not bool(active.any()):
                break
            hungarian_lap_reference.augmentation_steps += int(active.sum())
            j1 = way[lanes, j0]
            m_j1 = match[lanes, j1]
            at_j0 = (col_ids[None, :] == j0[:, None]) & active[:, None]
            match = torch.where(at_j0, m_j1[:, None], match)
            j0 = torch.where(active, j1, j0)

    mask = (match[:, None, :p] == row_ids[None, :, None]) & ~inactive[:, :, None]
    return mask.float()


# Dijkstra steps taken, summed over the problems: each relaxes the C columns
# of one problem; and the steps of the walks back along ``way``. A
# measurement counts the work its data needed with them.
hungarian_lap_reference.relaxations = 0
hungarian_lap_reference.augmentation_steps = 0


def _library() -> ctypes.CDLL:
    from boosted_detr_torch.ops import build

    lib = build.load("lap")
    lib.lap_solve.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])
    lib.lap_solve.restype = ctypes.c_int
    lib.lap_solve_columns.argtypes = ([ctypes.c_void_p] * 4
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
    lib.lap_solve_columns.restype = ctypes.c_int
    for name in ("lap_smem_bytes", "lap_columns_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int] * 2
        getattr(lib, name).restype = ctypes.c_longlong
    lib.lap_columns_slots.argtypes = [ctypes.c_int] * 2
    lib.lap_columns_slots.restype = ctypes.c_int
    lib.lap_error_string.argtypes = [ctypes.c_int]
    lib.lap_error_string.restype = ctypes.c_char_p
    return lib


def hungarian_lap(cost: torch.Tensor, num_objects: torch.Tensor
                  ) -> torch.Tensor:
    """Exact assignment mask [B, O, P] float32 of ``cost`` [B, O, P] with
    the first ``num_objects[b]`` rows of problem b taking part.

    CPU tensors go to ``hungarian_lap_reference``. A CUDA tensor launches
    the kernel or raises; there is no fallback. Each launch adds one to
    ``hungarian_lap.launches``."""
    _check(cost, num_objects)
    if cost.device.type == "cpu":
        return hungarian_lap_reference(cost, num_objects)
    if cost.device.type != "cuda":
        raise ValueError(f"hungarian_lap: cost on {cost.device}; it must be "
                         f"on a CUDA device or on the CPU")
    b, o, p = cost.shape
    if b * o * p == 0:
        return torch.empty((b, o, p), dtype=torch.float32, device=cost.device)
    plan = kernel_plan(o, p)
    cost = cost.detach().float().contiguous()
    n = num_objects.to(device=cost.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, o, p), dtype=torch.float32, device=cost.device)
    lib = _library()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.route == "slots":
            rc = lib.lap_solve(cost.data_ptr(), n.data_ptr(), out.data_ptr(),
                               b, o, p, stream)
        else:
            scratch = (torch.empty(b * plan.scratch, dtype=torch.uint8,
                                   device=cost.device)
                       if plan.scratch else None)
            rc = lib.lap_solve_columns(
                cost.data_ptr(), n.data_ptr(), out.data_ptr(),
                None if scratch is None else scratch.data_ptr(), b, o, p,
                stream)
    if rc != 0:
        raise RuntimeError(f"hungarian_lap launch failed: "
                           f"{lib.lap_error_string(rc).decode()} (B={b}, "
                           f"O={o}, P={p}, {plan.route} route)")
    hungarian_lap.launches += 1
    return out


hungarian_lap.launches = 0
