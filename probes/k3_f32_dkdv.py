"""K3's float32 dk/dv kernel at D = 128, in variants, on one card.

``boosted_detr_torch/csrc/attention.cu``'s CUDA-core dk/dv kernel
(``attn_dkdv_kernel<DPT, TPR>``) owns DPT of a key row's dims in each
thread and takes CHUNK query rows at a time. At D = 128 its layout as
first built (DPT 16, TPR 8: 512 threads, so at most 128 registers a
thread) left ptxas at 32 registers and 1976 bytes of spill stores, and
the kernel at 0.4% of its bound. This script makes variants of the
source by exact-match edits (``VARIANTS``; each edit must match exactly
once, so the script raises, rather than build something else, once the
kernel has changed), builds them with nvcc into ``build/probes/``, holds
each one's dk and dv against the plain version under ``chip_smoke.py``'s
float32 gradient gate, and times it by ``chip_smoke.py``'s two methods
(``ms``: from an idle card, L2 flushed; ``device_ms``: the launch
enqueued ahead of a spin on the card) at the two shapes of
``chip_smoke.py``'s K3 rows over D = 64. Run on a card from the root of a
checkout:

    python3 probes/k3_f32_dkdv.py [variant ...]

It prints the card's name and power limit, each variant's ptxas report of
the D = 128 dk/dv kernel and one JSON line a variant and shape.

It is the record of that measurement (PERF.md): the kernel has
since taken the last variant's layout at D = 128 (32 dims a thread, one
query row a step: ``dkdv_dpt`` in the source), so the edits no longer
match and the script raises instead of building something else.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from boosted_detr_torch.ops import attention as A  # noqa: E402
from boosted_detr_torch.ops import build  # noqa: E402

SOURCE = ROOT / "boosted_detr_torch" / "csrc" / "attention.cu"
OUT = ROOT / "build" / "probes"

_CHUNK = """  constexpr int CHUNK = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);"""
_BOUNDS = """__global__ void __launch_bounds__(ROWS * TPR)
attn_dkdv_kernel("""
_DPT = "constexpr int DPT_DKDV = 16;"

# name: [(text in the source, its replacement)]
VARIANTS = {
    "first": [],
    "min_blocks_1": [(_BOUNDS, _BOUNDS.replace("TPR)", "TPR, 1)"))],
    "chunk_2": [(_CHUNK, _CHUNK.replace("= 4", "= 2"))],
    "dpt_32": [(_DPT, _DPT.replace("16", "32"))],
    "dpt_32_chunk_2": [(_DPT, _DPT.replace("16", "32")),
                       (_CHUNK, _CHUNK.replace("= 4", "= 2"))],
    "dpt_32_chunk_1": [(_DPT, _DPT.replace("16", "32")),
                       (_CHUNK, _CHUNK.replace("= 4", "= 1"))],
}
SHAPES = ((32, 1600, 1600, 128), (128, 1600, 1600, 80))


def _build(name):
    text = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: an edit matches {text.count(old)} "
                               "times; the kernel has changed since")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"attention_{name}.cu"
    src.write_text(text)
    lib = OUT / f"libattention_{name}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(SOURCE.parent),
                           "-o", str(lib), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    return name, lib, proc.stdout + proc.stderr


def _bind(path):
    lib = ctypes.CDLL(str(path))
    fn = lib.attention_dkdv
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main(names):
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        built = list(pool.map(_build, names))
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for name, lib, log in built:
        report = chip_smoke.ptxas_k3(log).get("attn_dkdv_kernel D=128")
        print(f"[{name}] ptxas attn_dkdv_kernel D=128: {report}", flush=True)
        fn = _bind(lib)
        for seed, (bh, tq, tk, d) in enumerate(SHAPES):
            q, k, v, g, g_lse = chip_smoke._attention_inputs(
                bh, tq, tk, d, torch.float32, 70 + seed)
            ref, lse = A.attention_fwd_reference(q, k, v)
            delta = (g * ref).sum(-1) - g_lse
            want = A.attention_dkdv_reference(q, k, v, g, lse, delta)
            qp, kp, vp, gp = A._padded(q, k, v, g)
            dk, dv = torch.empty_like(kp), torch.empty_like(vp)
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                rc = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                        gp.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                        dk.data_ptr(), dv.data_ptr(), bh, tq, tk,
                        qp.shape[-1], 0, A._scale(d), stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")

            launch()
            torch.cuda.synchronize()
            what = f"{name} [{bh}, {tq}, {tk}, {d}] float32"
            err = max(chip_smoke._close(got[..., :d], ref_, atol=1e-4,
                                        rtol=1e-4, what=f"{what} {x}")
                      for x, got, ref_ in (("dk", dk, want[0]),
                                           ("dv", dv, want[1])))
            row = {"variant": name, "shape": [bh, tq, tk, d],
                   "max_abs_err": err, "ptxas": report,
                   "ms": chip_smoke._time_ms(launch, flush, repeats=5),
                   "device_ms": chip_smoke._time_ms(
                       launch, flush, repeats=5,
                       spin_cycles=chip_smoke.SPIN_CYCLES)}
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        print("k3_f32_dkdv: no CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
