"""Where the time of K3's resident bf16 wide forward goes, on one card.

``boosted_detr_torch/csrc/attention.cu``'s ``attn_fwd_wide_mma_kernel<NC>``
(D = 256 and 384) runs, a 64-key tile at a time, the logits on wgmma,
the softmax on the CUDA cores and P.V on wgmma (p's hi, then lo), with
TMA loads of k and v. This script makes variants of the source by the
exact-match edits of ``VARIANTS`` (each must match where it is applied:
they fit the kernel as it stood when these were measured, and the script
raises, rather than build something else, once the kernel has changed),
builds each with nvcc into ``build/probes/``, and times it beside the
committed kernel in the same process by ``chip_smoke.py``'s ``device_ms``
(the launch enqueued ahead of a spin on the card, the L2 flushed):

  - ``shipped``: the committed kernel, held against
    ``attention_fwd_emulation`` (the share of equal bf16 values);
  - ``branch``: P.V's steps past Tk skipped by a branch among the wgmmas,
    as the D <= 128 kernel skips them: ptxas then serialises every wgmma
    (each waits for the one before), which its report names;
  - ``no_pv``, ``no_logits``, ``no_products``: P.V's wgmmas, the logits'
    wgmmas, or both, left out (their registers kept live), so the time
    left is the rest: the loads, the barriers and the softmax. Their
    outputs are wrong; they are timed only.

Run on a card from the root of a checkout:

    python3 probes/k3_fwd_parts.py

It prints the card's name and power limit, each variant's ptxas registers,
spills and serialisation notes for the forward, the forward's warpgroup
products in its SASS (``cuobjdump -sass``: each ``HGMMA`` form, which is
``wgmma.mma_async``, with its count, and the count of waits on them,
``WARPGROUP.DEPBAR``), and one JSON line a variant and shape.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "boosted_detr_torch" / "csrc" / "attention.cu"
OUT = ROOT / "build" / "probes"

_PV = """      wgmma_rs<P::OWN>(acc_flat, hi[cs], b);
      wgmma_rs<P::OWN>(acc_flat, lo[cs], b);
"""
_PV_KEPT = """      asm volatile("" :: "l"(b), "r"(hi[cs][0]), "r"(hi[cs][1]),
                   "r"(hi[cs][2]), "r"(hi[cs][3]), "r"(lo[cs][0]),
                   "r"(lo[cs][1]), "r"(lo[cs][2]), "r"(lo[cs][3]));
"""
_LOGITS = """      wgmma_m64n64k16_ss(s_flat, sw128_descriptor(q_rows + at, 0),
                         sw128_descriptor(k_tile + at, 0), kk > 0);
"""
_LOGITS_KEPT = """      if (kk == 0)
        for (int e = 0; e < 32; ++e)
          s_flat[e] = 1e-3f * (e + static_cast<int>(threadIdx.x));
"""
_STEPS = """    for (int cs = 0; cs < STEPS; ++cs) {
      const uint64_t b =
          sw128_descriptor(v_cols + cs * STEP * 2 * SLAB, SLAB_BYTES);
"""
_STEPS_BRANCH = """    for (int cs = 0; cs < STEPS; ++cs) {
      if (k0 + cs * STEP >= Tk) break;  // the same for every thread
      const uint64_t b =
          sw128_descriptor(v_cols + cs * STEP * 2 * SLAB, SLAB_BYTES);
"""
VARIANTS = {
    "shipped": (),
    "branch": ((_STEPS, _STEPS_BRANCH),),
    "no_pv": ((_PV, _PV_KEPT),),
    "no_logits": ((_LOGITS, _LOGITS_KEPT),),
    "no_products": ((_PV, _PV_KEPT), (_LOGITS, _LOGITS_KEPT)),
}
# (BH, Tq, Tk, D): vit_l16_h4's blocks, D = 160 padded to 256, D = 384
SHAPES = ((32, 1600, 1600, 256), (16, 400, 400, 160), (8, 400, 400, 384))
FWD = "attn_fwd_wide_mma_kernelILi"


def _variant(edits) -> str:
    text = SOURCE.read_text()
    start = text.index("// ---- the bf16 forward at D = 256 and 384")
    end = text.index("// ---- float32 at D = 128 nc", start)
    section = text[start:end]
    for old, new in edits:
        if section.count(old) != 1:
            raise RuntimeError(f"the kernel has changed: an edit matches "
                               f"{section.count(old)} times, not once:\n"
                               f"{old}")
        section = section.replace(old, new)
    return text[:start] + section + text[end:]


def _build(name: str, text: str) -> Path:
    from boosted_detr_torch.ops import build

    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"k3_fwd_{name}.cu"
    lib = OUT / f"libk3_fwd_{name}.so"
    src.write_text(text)
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(SOURCE.parent), "-o", str(lib), str(src)],
                          capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    (OUT / f"libk3_fwd_{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
    entry = None
    for line in log.splitlines():
        found = re.search(rf"Compiling entry function '\S*{FWD}(\d)", line)
        if found:
            entry = f"NC={found.group(1)}"
        elif "Compiling entry" in line:
            entry = None
        if entry and ("registers" in line or "spill" in line):
            print(f"  {name} {entry}: {line.strip()}", flush=True)
        if FWD in line and "Potential Performance Loss" in line:
            note = line.split("Potential Performance Loss: ")[1]
            print(f"  {name}: {note.split(' in the function')[0]} "
                  f"(NC={line.split(FWD)[1][0]})", flush=True)
    _sass(name, lib, Path(build._nvcc()).with_name("cuobjdump"))
    return lib


def _sass(name: str, lib: Path, cuobjdump: Path):
    """The forward's HGMMA forms and their counts, and its DEPBAR waits, in
    the SASS of ``lib``, one line an instantiation."""
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True,
                          check=False).stdout
    for function in sass.split("Function : ")[1:]:
        entry = re.search(rf"{FWD}(\d)", function.split("\n")[0])
        if not entry:
            continue
        forms = {}
        for op in re.findall(r"HGMMA\.\S+", function):
            forms[op] = forms.get(op, 0) + 1
        waits = len(re.findall(r"WARPGROUP\.DEPBAR", function))
        print(f"  {name} NC={entry.group(1)} SASS: {forms}; "
              f"{waits} WARPGROUP.DEPBAR", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k3_fwd_parts: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    libs = {}
    for name, edits in VARIANTS.items():
        lib = ctypes.CDLL(str(_build(name, _variant(edits))))
        lib.attention_fwd.argtypes = ([ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 5
                                      + [ctypes.c_float, ctypes.c_void_p])
        lib.attention_fwd.restype = ctypes.c_int
        libs[name] = lib
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(500)
    for bh, tq, tk, d in SHAPES:
        q, k, v = (torch.randn((bh, t, d), generator=gen, device="cuda")
                   .bfloat16() for t in (tq, tk, tk))
        qp, kp, vp = A._padded(q, k, v)
        out = torch.empty_like(qp)
        lse = torch.empty((bh, tq), device="cuda")

        def launch(lib):
            rc = lib.attention_fwd(
                qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
                lse.data_ptr(), bh, tq, tk, qp.shape[-1], 1, A._scale(d),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        want = A.attention_fwd_emulation(qp.cpu(), kp.cpu(), vp.cpu(),
                                         scale=A._scale(d))[0]
        for name, lib in libs.items():
            launch(lib)
            torch.cuda.synchronize()
            row = {"variant": name, "shape": [bh, tq, tk, d],
                   "device_ms": cs._time_ms(lambda: launch(lib), flush,
                                            spin_cycles=cs.SPIN_CYCLES)}
            if name in ("shipped", "branch"):
                row["equal_to_emulation"] = (
                    out.cpu().float() == want.float()).float().mean().item()
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
