"""ctypes binding of the port's copy of the native JPEG batch loader
(native/imgload/imgload.cpp: libjpeg decode, bilinear resize, a pool of
worker threads), as boosted_detr_tpu/native/imgload_binding.py:
``load_jpeg_batch(paths, (h, w))`` decodes a whole batch into one float32
array. Non-JPEG files report failure, and the caller decodes them another
way. The library is built at first use into ``build/native/``
(``native.load_library``, linked with -ljpeg)."""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Sequence, Tuple

import numpy as np

from boosted_detr_torch.native import HERE, load_library

_SRC = HERE / "imgload" / "imgload.cpp"


@functools.cache
def load() -> ctypes.CDLL:
    lib = load_library(_SRC, libs=("-ljpeg", "-lpthread"))
    lib.imgload_batch.restype = ctypes.c_int
    lib.imgload_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32)]
    return lib


def load_jpeg_batch(paths: Sequence[str], image_size: Tuple[int, int],
                    num_threads: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Decode and resize JPEGs -> (images [B, H, W, 3] f32 in [0, 1],
    ok [B] bool). ``num_threads=0`` uses ``os.cpu_count()``."""
    lib = load()
    b = len(paths)
    h, w = image_size
    out = np.zeros((b, h, w, 3), np.float32)
    ok = np.zeros((b,), np.int32)
    arr = (ctypes.c_char_p * b)(*[p.encode() for p in paths])
    threads = num_threads or (os.cpu_count() or 1)
    lib.imgload_batch(arr, b, h, w, min(threads, b),
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, ok.astype(bool)
