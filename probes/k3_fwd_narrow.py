"""Design variants of K3's bf16 forward up to D = 128, on one card.

``boosted_detr_torch/csrc/attention.cu``'s ``attn_fwd_wgmma_kernel<D>`` runs,
a 64-key tile at a time, S = q k^T on wgmma, the online softmax on the CUDA
cores and P.V on wgmma (p's hi, then lo), with TMA loads of k and v into a
ring of stages that carry both; at D <= 64 its rows are one 64-dim slab
(TMA's zeros past dim 32 at D = 32) and its blocks one warpgroup of 64 rows
(``FwdNarrowPlan``), at D = 80 and 128 two. This script makes variants of
the source by the exact-match edits of ``VARIANTS`` (each must match once:
they fit the kernel as it stood when these were measured, and the script
raises, rather than build something else, once it has changed), builds each
with nvcc into ``build/probes/`` (all at once), and times each beside the
committed kernel at ``TIMED``:

  - ``rows_128``: blocks of two warpgroups (128 rows) at D <= 64 too, their
    registers sized as they were for them (80 a thread at D = 32, 128 at
    64);
  - ``blocks<D>_<n>``: FWD_BLOCKS_32 or FWD_BLOCKS_64 = n, the blocks of
    one warpgroup an SM that D = 32 or 64 sizes its registers for (two: up
    to 255 a thread, four: 128, six: 80);
  - ``stages_<n>``: FWD_NARROW_STAGES = n, the stages of the k and v ring
    at D <= 64;
  - ``one_block``: one block an SM at D = 80 and 128 (up to 255 registers a
    thread; two blocks, one's softmax beside the other's products, ran
    faster).

A variant equal to the committed source is not built. ``sweep`` times the
committed kernel and ``rows_128`` at D = 32 and 64 over Tq and Tk in
``SWEEP``, and, given a checkout of the tree before this design (whose
bf16 forward at D <= 64 is ``attn_fwd_mma_kernel``, ``mma.sync``), builds
its ``attention.cu`` and times it there too, each out held against the
committed kernel's (the share of equal bf16 values, the largest ulp
difference, the lse's largest difference). Every time is
``chip_smoke.py``'s ``device_ms`` (the launch enqueued ahead of a spin on
the card, the L2 flushed), each library twice in mirrored order.

Every variant is held against ``attention_fwd_emulation`` (the share of
equal bf16 values, the lse's largest difference) and against the committed
kernel's bits, at the timed shapes and at ragged ones. Run on a card from
the root of a checkout:

    python3 probes/k3_fwd_narrow.py [variant,...|sweep] [checkout]

(no argument: every variant, then the sweep without a checkout). It prints
the card's name and power limit, each build's ptxas registers, spills and
serialisation notes for the forward, and one JSON line a variant or sweep
point and shape.
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
FWD = "attn_fwd_(?:wgmma|mma)_kernelILi"

_WGS = "  static constexpr int WGS = D > SLAB ? NARROW_WGS : FWD_NARROW_WGS;"
_BLOCKS = "      D <= 32 ? FWD_BLOCKS_32 : D <= SLAB ? FWD_BLOCKS_64 : "


def _constant(name: str, value: int):
    """The edit that sets ``constexpr int <name>`` to ``value``, or None
    where the source already holds that value."""
    text = SOURCE.read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    if len(found) != 1:
        raise RuntimeError(f"the kernel has changed: {name} is defined "
                           f"{len(found)} times")
    if int(found[0]) == value:
        return None
    return (f"constexpr int {name} = {found[0]};",
            f"constexpr int {name} = {value};")


def _variants():
    out = {"shipped": ()}
    # two warpgroups a block at D <= 64, registers of three (D = 32) and two
    # (64) such blocks an SM
    out["rows_128"] = tuple(
        edit for edit in ((_WGS, "  static constexpr int WGS = NARROW_WGS;"),
                          _constant("FWD_BLOCKS_32", 3),
                          _constant("FWD_BLOCKS_64", 2)) if edit)
    for d, counts in ((32, (4, 6)), (64, (2, 4, 6))):
        for n in counts:
            edit = _constant(f"FWD_BLOCKS_{d}", n)
            if edit:
                out[f"blocks{d}_{n}"] = (edit,)
    for n in (2, 3):
        edit = _constant("FWD_NARROW_STAGES", n)
        if edit:
            out[f"stages_{n}"] = (edit,)
    out["one_block"] = ((_BLOCKS + "2;", _BLOCKS + "1;"),)
    return out


VARIANTS = _variants()
# (BH, Tq, Tk, D): the main paths' shapes (timed for every variant), and
# ragged ones (checked only)
TIMED = ((64, 1600, 1600, 32), (48, 1600, 1600, 64), (64, 96, 1600, 32),
         (64, 96, 96, 32), (64, 400, 400, 32), (64, 96, 400, 32),
         (16, 300, 520, 64), (128, 1600, 1600, 80), (32, 1600, 1600, 128))
RAGGED = ((2, 130, 70, 32), (3, 17, 1000, 64), (3, 520, 17, 32),
          (3, 17, 1, 64), (2, 130, 70, 80), (3, 520, 17, 128))
# the sweep: BH (the ViT-p16 blocks' 48 heads at D = 64, the DETR
# transformer's 64 at D = 32) and the stream lengths
SWEEP_BH = {32: 64, 64: 48}
SWEEP = (64, 96, 128, 192, 256, 400, 1600)


def _variant(edits) -> str:
    text = SOURCE.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"the kernel has changed: an edit matches "
                               f"{text.count(old)} times, not once:\n{old}")
        text = text.replace(old, new)
    return text


def _build(name: str, text: str, include: Path):
    """(the library, its ptxas lines for the forward) of one source."""
    from boosted_detr_torch.ops import build

    src = OUT / f"k3_fwd_narrow_{name}.cu"
    lib = OUT / f"libk3_fwd_narrow_{name}.so"
    src.write_text(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(include), "-o", str(lib), str(src)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    (OUT / f"libk3_fwd_narrow_{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
    notes, entry = [], None
    for line in log.splitlines():
        found = re.search(rf"Compiling entry function '\S*({FWD}\d+)", line)
        if found:
            entry = found.group(1)
        elif "Compiling entry" in line:
            entry = None
        if entry and ("registers" in line or "spill" in line):
            notes.append(f"  {name} {entry}: {line.strip()}")
        if (re.search(FWD, line)
                and "Potential Performance Loss" in line):
            notes.append(f"  {name}: " + line.split(
                "Potential Performance Loss: ")[1].split(" in the function")[0])
    return lib, notes


def _bind(path):
    lib = ctypes.CDLL(str(path))
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    lib.attention_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
    lib.attention_fwd.restype = ctypes.c_int
    return lib


def _launcher(torch, A, lib, q, k, v, out, lse):
    bh, tq, d = q.shape

    def launch():
        rc = lib.attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, tq, k.shape[1], d, 1, A._scale(d),
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
    return launch


def _ulps(torch, a, b) -> int:
    """The largest distance of two bf16 tensors in units in the last place
    (their bits as integers in the order of the values)."""
    def ordered(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -32768 - i, i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def _sweep(torch, cs, A, libs, flush, gen):
    """The committed kernel, ``rows_128`` and, where given, the earlier
    tree's kernel at every (Tq, Tk) of the sweep, by device_ms."""
    names = [n for n in ("shipped", "rows_128", "parent") if n in libs]
    for d in (32, 64):
        bh = SWEEP_BH[d]
        for tq in SWEEP:
            for tk in SWEEP:
                q, k, v = (torch.randn((bh, t, d), generator=gen,
                                       device="cuda").bfloat16()
                           for t in (tq, tk, tk))
                outs, launch = {}, {}
                for name in names:
                    out = torch.empty_like(q)
                    lse = torch.empty((bh, tq), device="cuda")
                    launch[name] = _launcher(torch, A, libs[name], q, k, v,
                                             out, lse)
                    launch[name]()
                    outs[name] = (out, lse)
                torch.cuda.synchronize()
                row = {"sweep": [bh, tq, tk, d]}
                times = {n: [] for n in names}
                for name in names + names[::-1]:
                    times[name].append(cs._time_ms(
                        launch[name], flush, spin_cycles=cs.SPIN_CYCLES))
                base_out, base_lse = outs["shipped"]
                for name in names:
                    row[f"{name}_device_ms"] = sum(times[name]) / 2
                    if name == "shipped":
                        continue
                    out, lse = outs[name]
                    row[f"{name}_equal"] = (
                        out == base_out).float().mean().item()
                    row[f"{name}_max_ulps"] = _ulps(torch, out, base_out)
                    row[f"{name}_lse_max_diff"] = (
                        lse - base_lse).abs().max().item()
                print(json.dumps(row), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_fwd_narrow: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import attention as A

    chosen = sys.argv[1].split(",") if len(sys.argv) > 1 else None
    parent = Path(sys.argv[2]).resolve() if len(sys.argv) > 2 else None
    sweep = chosen is None or "sweep" in chosen
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    names = [n for n in VARIANTS if chosen is None or n in chosen
             or n == "shipped" or (sweep and n == "rows_128")]
    sources = {name: (_variant(VARIANTS[name]), SOURCE.parent)
               for name in names}
    if parent is not None:
        csrc = parent / "boosted_detr_torch" / "csrc"
        sources["parent"] = ((csrc / "attention.cu").read_text(), csrc)
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        built = dict(zip(sources, pool.map(
            lambda kv: _build(kv[0], *kv[1]), sources.items())))
    libs = {}
    for name, (path, notes) in built.items():
        print("\n".join(notes), flush=True)
        libs[name] = _bind(path)
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(700)
    if sweep:
        _sweep(torch, cs, A, libs, flush, gen)
    variants = {n: lib for n, lib in libs.items() if n != "parent"
                and (chosen is None or n in chosen or n == "shipped")}
    if len(variants) < 2:
        return 0
    for bh, tq, tk, d in TIMED + RAGGED:
        q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda")
                   .bfloat16() for t in (tq, tk, tk))
        out = torch.empty_like(q)
        lse = torch.empty((bh, tq), device="cuda")
        want, want_lse = A.attention_fwd_emulation(q, k, v)
        shipped = None
        for name, lib in variants.items():
            launch = _launcher(torch, A, lib, q, k, v, out, lse)
            out.zero_()
            launch()
            torch.cuda.synchronize()
            row = {"variant": name, "shape": [bh, tq, tk, d],
                   "equal_to_emulation":
                       (out == want).float().mean().item(),
                   "lse_max_diff": (lse - want_lse).abs().max().item()}
            if shipped is None:
                shipped = (out.clone(), lse.clone())
            else:
                row["bits_of_shipped"] = bool(torch.equal(out, shipped[0])
                                              and torch.equal(lse,
                                                              shipped[1]))
            if (bh, tq, tk, d) in TIMED:
                row["device_ms"] = cs._time_ms(launch, flush,
                                               spin_cycles=cs.SPIN_CYCLES)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
