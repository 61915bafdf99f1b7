"""The host's native libraries, copies of boosted_detr_tpu/native/: the
batched LAP solver (``lap/lap.cpp``, ``lap_binding``) and the JPEG batch
loader (``imgload/imgload.cpp``, ``imgload_binding``), each bound with
``ctypes``.

g++ builds a library at its first use into ``build/native/`` at the root
of the checkout, named by a digest of its source and flags, so that an
edited source builds anew; nothing is built beside the source, and the
JAX package's libraries are never built or loaded from here."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def library_path(source: Path, libs: Sequence[str] = ()) -> Path:
    flags = " ".join(GXX_FLAGS + tuple(libs)).encode()
    digest = hashlib.sha256(source.read_bytes() + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def load_library(source: Path, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """``source`` compiled with g++ into ``build/native/`` unless its
    library exists, then loaded. Raises ``RuntimeError`` if g++ fails."""
    out = library_path(source, libs)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(source), "-o", str(tmp), *libs]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {source.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees no half file
    return ctypes.CDLL(str(out))
