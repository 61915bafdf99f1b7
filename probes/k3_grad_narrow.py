"""Design variants of K3's bf16 dq and dk/dv at D = 32 and 64, on one card.

``boosted_detr_torch/csrc/attention.cu``'s ``attn_dq_wgmma_kernel<D>`` and
``attn_dkdv_wgmma_kernel<D>`` run, a 64-row tile at a time, the first
products (S and dP) on wgmma, p and ds on the CUDA cores (one ex2 a value,
each split into bf16 hi and lo) and the second products on wgmma from
registers, with TMA loads into two stages. This script makes variants of
the source by the exact-match edits of ``VARIANTS`` (each must match as
often as it says: they fit the kernels as they stood when these were
measured, and the script raises, rather than build something else, once
the source has changed), builds each with nvcc into ``build/probes/`` (all
at once), and times its dq and dk/dv beside the committed kernels in the
same process by ``chip_smoke.py``'s ``device_ms`` (the launch enqueued
ahead of a spin on the card, the L2 flushed):

  - ``shipped``: the committed kernels;
  - ``no_short_stream``: every stream on the wgmma kernels (SHORT_STREAM
    0), which shows where the ``mma.sync`` kernels' 64-row blocks beat
    them over short streams (the timed shapes sweep Tq and Tk over 64-256
    rows at D = 32 and 64);
  - ``dq_mask_every_tile``: dq masks p past Tk by a compare and a select
    on every value of every tile at D <= 64 too, as it does at 80 and 128
    and as dk/dv does, instead of in the last tile alone once no product
    is in flight;
  - ``dkdv_mask_last_tile``: dk/dv masks p past Tq as dq does;
  - ``dkdv_one_block``: dk/dv asks registers for one block an SM (up to
    255 a thread) at D = 32 too (and then splits ds while dV's products
    run, as at one block it does);
  - ``dkdv_split_during_dv``: dk/dv at two blocks an SM (D = 32) splits
    ds while dV's products run, as at one block, instead of before it
    issues them;
  - ``dkdv_split_first_always``: dk/dv at one block an SM (D = 64) splits
    ds before it issues dV's products, as at two blocks;
  - ``dq_one_block``: dq asks registers for one block an SM at D <= 64.

The readings of variants that this script no longer builds (dq's second
products left in flight over the next tile, D = 32 in a 64-byte swizzle,
integer hi/lo rounding, and the timing-only ones without ``ex2`` or
without the lo products) are in PERF.md.

Every variant is held against ``attention_dq_emulation`` and
``attention_dkdv_emulation`` (the share of equal bf16 values) and against
the shipped kernels' bits, at the timed shapes and at ragged ones. Run on
a card from the root of a checkout:

    python3 probes/k3_grad_narrow.py

or name the variants to build, ``python3 probes/k3_grad_narrow.py
shipped,no_short_stream``. It prints the card's name and power limit,
each variant's ptxas registers and spills for dq and dk/dv at D = 32 and
64, and one JSON line a variant and shape.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "boosted_detr_torch" / "csrc" / "attention.cu"
OUT = ROOT / "build" / "probes"
KERNELS = ("attn_dq_wgmma_kernelILi", "attn_dkdv_wgmma_kernelILi")

_DKDV_BLOCKS = """__host__ __device__ constexpr int dkdv_wgmma_blocks() {
  return D > 32 ? 1 : 2;
}"""
_DQ_BLOCKS = ("constexpr int dq_wgmma_blocks() { return D > SLAB ? 1 : 2; }")
_DQ_EXP = """              D <= SLAB || key < Tk"""
_DQ_EXP_MASKED = """              key < Tk"""
_DKDV_EXP = """#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[cs][j][e] = exp2_approx(s[cs][j][e] * scale2 - lse2[e % 2]);
      }
    wgmma_wait<0>();
    wgmma_hold(dp_flat);
    // query rows past Tq (TMA's zero rows) are masked out of p, in the last
    // tile alone, once no product is in flight
    if (q0 + TILE > Tq) mask_columns(s, Tq - q0, tig);
"""
_DKDV_EXP_MASKED = """#pragma unroll
        for (int e = 0; e < 4; ++e)  // query rows past Tq are masked out
          s[cs][j][e] = q0 + col + e % 2 < Tq
                            ? exp2_approx(s[cs][j][e] * scale2 - lse2[e % 2])
                            : 0.f;
      }
    wgmma_wait<0>();
    wgmma_hold(dp_flat);
"""
_DKDV_SPLIT = "constexpr bool SPLIT_FIRST = dkdv_wgmma_blocks<D>() == 2;"

_SHORT = "constexpr int SHORT_STREAM = 2 * TILE;"

# name: ((old, new, times the old text must match), ...)
VARIANTS = {
    "shipped": (),
    "no_short_stream": ((_SHORT, _SHORT.replace("2 * TILE", "0"), 1),),
    "dq_mask_every_tile": ((_DQ_EXP, _DQ_EXP_MASKED, 1),
                           ("if constexpr (D <= SLAB) {\n      if (k0",
                            "if constexpr (false) {\n      if (k0", 1)),
    "dkdv_mask_last_tile": ((_DKDV_EXP_MASKED, _DKDV_EXP, 1),),
    "dkdv_one_block": ((_DKDV_BLOCKS, _DKDV_BLOCKS.replace("? 1 : 2",
                                                           "? 1 : 1"), 1),),
    "dkdv_split_during_dv": ((_DKDV_SPLIT, _DKDV_SPLIT.replace(
        "dkdv_wgmma_blocks<D>() == 2", "false"), 1),),
    "dkdv_split_first_always": ((_DKDV_SPLIT, _DKDV_SPLIT.replace(
        "dkdv_wgmma_blocks<D>() == 2", "true"), 1),),
    "dq_one_block": ((_DQ_BLOCKS, _DQ_BLOCKS.replace("? 1 : 2", "? 1 : 1"),
                      1),),
}
# (BH, Tq, Tk, D): the 1280 encoder's, ViT-p16's, vit_h16's and
# vit_w512_h4's blocks, the DETR decoder's short streams and a sweep of
# them past SHORT_STREAM (timed), and ragged shapes (checked only)
STREAMS = (64, 96, 128, 192, 256)
TIMED = ((64, 1600, 1600, 32), (48, 1600, 1600, 64), (128, 1600, 1600, 80),
         (32, 1600, 1600, 128), (64, 96, 96, 32), (64, 96, 400, 32),
         (16, 300, 520, 64),
         *((64, n, 1600, d) for d in (32, 64) for n in STREAMS),
         *((64, 1600, n, d) for d in (32, 64) for n in STREAMS))
RAGGED = ((3, 1, 300, 32), (3, 300, 1, 64), (3, 17, 17, 64),
          (3, 520, 17, 32), (3, 17, 129, 64), (3, 129, 17, 32))


def _variant(edits) -> str:
    text = SOURCE.read_text()
    for old, new, times in edits:
        if text.count(old) != times:
            raise RuntimeError(f"the source has changed: an edit matches "
                               f"{text.count(old)} times, not {times}:\n"
                               f"{old}")
        text = text.replace(old, new)
    return text


def _build(name: str, text: str):
    """(the library, its ptxas lines for dq and dk/dv) of one variant."""
    from boosted_detr_torch.ops import build

    src = OUT / f"k3_grad_narrow_{name}.cu"
    lib = OUT / f"libk3_grad_narrow_{name}.so"
    src.write_text(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(SOURCE.parent), "-o", str(lib), str(src)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    (OUT / f"libk3_grad_narrow_{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
    notes, entry = [], None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '\S*?(attn_\w+_wgmma)"
                          r"_kernelILi(\d+)", line)
        if found and found.group(1) != "attn_fwd_wgmma":
            entry = f"{found.group(1)} D={found.group(2)}"
        elif "Compiling entry" in line:
            entry = None
        if entry and ("registers" in line or "spill" in line):
            notes.append(f"  {name} {entry}: {line.strip()}")
        if (any(k in line for k in KERNELS)
                and "Potential Performance Loss" in line):
            notes.append(f"  {name}: " + line.split(
                "Potential Performance Loss: ")[1].split(" in the function")[0])
    return lib, notes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_grad_narrow: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    wanted = sys.argv[1].split(",") if len(sys.argv) > 1 else list(VARIANTS)
    texts = {name: _variant(VARIANTS[name]) for name in wanted}
    with ThreadPoolExecutor(max_workers=len(texts)) as pool:
        built = dict(zip(texts, pool.map(lambda kv: _build(*kv),
                                         texts.items())))
    libs = {}
    for name, (path, notes) in built.items():
        print("\n".join(notes), flush=True)
        lib = ctypes.CDLL(str(path))
        tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        lib.attention_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        lib.attention_dkdv.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.attention_dq.restype = lib.attention_dkdv.restype = ctypes.c_int
        libs[name] = lib
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(710)
    for bh, tq, tk, d in TIMED + RAGGED:
        q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda")
                      .bfloat16() for t in (tq, tk, tk, tq))
        logits = (q.float() * d ** -0.5) @ k.float().transpose(1, 2)
        lse = torch.logsumexp(logits, -1)
        o = (torch.softmax(logits, -1) @ v.float()).bfloat16()
        del logits
        g_lse = torch.randn((bh, tq), generator=gen, device="cuda")
        delta = (g.float() * o.float()).sum(-1) - g_lse
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        ptrs = [t.data_ptr() for t in (q, k, v, g, lse, delta)]

        def launch(lib, kind):
            stream = torch.cuda.current_stream().cuda_stream
            if kind == "dq":
                rc = lib.attention_dq(*ptrs, dq.data_ptr(), bh, tq, tk, d, 1,
                                      A._scale(d), stream)
            else:
                rc = lib.attention_dkdv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                        bh, tq, tk, d, 1, A._scale(d),
                                        stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        want = (A.attention_dq_emulation(q, k, v, g, lse, delta),
                *A.attention_dkdv_emulation(q, k, v, g, lse, delta))
        shipped = None
        for name, lib in libs.items():
            for t in (dq, dk, dv):
                t.zero_()
            launch(lib, "dq")
            launch(lib, "dkdv")
            torch.cuda.synchronize()
            got = (dq.clone(), dk.clone(), dv.clone())
            row = {"variant": name, "shape": [bh, tq, tk, d],
                   "equal_to_emulation": [(a == b).float().mean().item()
                                          for a, b in zip(got, want)]}
            if shipped is None:
                shipped = got
            else:
                row["bits_of_shipped"] = all(
                    torch.equal(a, b) for a, b in zip(got, shipped))
            if (bh, tq, tk, d) in TIMED:
                for kind in ("dq", "dkdv"):
                    row[f"{kind}_device_ms"] = cs._time_ms(
                        lambda: launch(lib, kind), flush,
                        spin_cycles=cs.SPIN_CYCLES)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
