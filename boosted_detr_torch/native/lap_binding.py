"""ctypes binding of the port's copy of the native batched LAP solver
(native/lap/lap.cpp), the host-side matcher of
boosted_detr_tpu/native/lap_binding.py: ``lap_solve_batch`` and
``lap_total_cost``. The library is built at first use into
``build/native/`` (``native.load_library``)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from boosted_detr_torch.native import HERE, load_library

_SRC = HERE / "lap" / "lap.cpp"
_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def load() -> ctypes.CDLL:
    lib = load_library(_SRC)
    lib.lap_solve_batch.restype = None
    lib.lap_solve_batch.argtypes = [_F32, ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, _I32, _F32]
    lib.lap_total_cost.restype = ctypes.c_double
    lib.lap_total_cost.argtypes = [_F32, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32, _I32]
    return lib


def _inputs(cost: np.ndarray, num_objects: np.ndarray):
    cost = np.ascontiguousarray(cost, np.float32)
    n = np.ascontiguousarray(num_objects, np.int32).reshape(-1)
    if cost.ndim != 3 or n.shape != (cost.shape[0],):
        raise ValueError(f"cost [B, O, P] and num_objects [B] expected, got "
                         f"{cost.shape} and {n.shape}")
    if (n > min(cost.shape[1:])).any():
        raise ValueError("num_objects exceeds the rows or the columns of "
                         "the cost")
    return cost, n


def lap_solve_batch(cost: np.ndarray, num_objects: np.ndarray) -> np.ndarray:
    """cost [B, O, P] f32, num_objects [B] int32 -> mask [B, O, P] f32:
    one 1 in each of the first ``num_objects[i]`` rows of problem i."""
    lib = load()
    cost, n = _inputs(cost, num_objects)
    b, o, p = cost.shape
    mask = np.zeros_like(cost)
    lib.lap_solve_batch(cost.ctypes.data_as(_F32), b, o, p,
                        n.ctypes.data_as(_I32), mask.ctypes.data_as(_F32))
    return mask


def lap_total_cost(cost: np.ndarray, num_objects: np.ndarray) -> float:
    """The summed cost of the optimal assignments of every problem."""
    lib = load()
    cost, n = _inputs(cost, num_objects)
    b, o, p = cost.shape
    return float(lib.lap_total_cost(cost.ctypes.data_as(_F32), b, o, p,
                                    n.ctypes.data_as(_I32)))
