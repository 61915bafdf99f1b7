"""K3's float32 backward at D = 256 on one card: the TF32 kernels
(``attn_dq_wide_tf32_kernel``, ``attn_dkdv_wide_tf32_kernel``, with the
``tf32_split_kernel`` pass before each) beside the CUDA-core kernels they
replaced (``attn_dq_wide_kernel``, ``attn_dkdv_wide_kernel``), each source
built and timed in one process.

Each ``attention.cu`` given (a parent's, from ``git archive`` unpacked into
a directory that ``.gitignore`` lists, and this tree's) is built with nvcc
into ``build/probes/`` and called through ctypes: a source with the
``attention_dq_tf32`` / ``attention_dkdv_tf32`` entries through those (the
split pass and the kernel, scratch allocated once), any other through
``attention_dq`` / ``attention_dkdv`` at D = 256. At every shape
(``chip_smoke.py``'s float32 rows past 128 by default: [32, 1600, 1600,
256], vit_l16_h4's blocks, and [16, 400, 400, 160] padded to 256) it
prints one JSON line a build and kernel: ``ms`` (from an idle card, L2
flushed) and ``device_ms`` (the launch enqueued ahead of a spin on the
card), as ``chip_smoke.py`` times them; the largest difference from the
plain version (``attention_dq_reference``, ``attention_dkdv_reference``)
and whether it passes the float32 gates (1e-4 / 1e-4, and the GPU tests'
1e-5 of the largest value / 1e-4); for the TF32 builds the largest
difference from this tree's emulation (on the inputs padded to 256,
where it takes the TF32 kernels' arithmetic) relative to the largest
value, and whether a second launch gave the same bits. Then
ptxas's registers, spills and any C75xx note of each build's K3 float32
kernels.

``--variants`` builds this tree's source once more for each variant
named, by exact edits behind a shipped constant (``VARIANTS``):
``dq_stages8`` (``TF32_DQ_STAGES`` 12 -> 8), ``dkdv_stages3``
(``TF32_DKDV_STAGES`` 5 -> 3), ``serial`` (``TF32_IN_FLIGHT`` 1 -> 0: every
unit's products done before the next unit's are issued). Run on a card
from the root of a checkout:

    python3 probes/k3_f32_backward.py [path/to/attention.cu ...]
        [--variants dq_stages8 dkdv_stages3 serial]
        [--shapes BH,Tq,Tk,D ...]

It prints the card's name, power limit and SM clocks first.
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
SHAPES = ((32, 1600, 1600, 256), (16, 400, 400, 160))
VARIANTS = {
    "dq_stages8": (("constexpr int TF32_DQ_STAGES = 12;",
                    "constexpr int TF32_DQ_STAGES = 8;"),),
    "dkdv_stages3": (("constexpr int TF32_DKDV_STAGES = 5;",
                      "constexpr int TF32_DKDV_STAGES = 3;"),),
    "serial": (("constexpr int TF32_IN_FLIGHT = 1;",
                "constexpr int TF32_IN_FLIGHT = 0;"),),
}


def variant_source(src: str, name: str) -> str:
    """``src`` with the edits of variant ``name``, each of which must match
    exactly once."""
    for old, new in VARIANTS[name]:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the source has {src.count(old)} "
                               f"matches of {old!r}")
        src = src.replace(old, new)
    return src


def _build(text: str, tag: str):
    from boosted_detr_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"attention_{tag}.cu"
    cu.write_text(text)
    lib = out_dir / f"libattention_{tag}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-4000:]}")
    # ptxas's registers and spills of the float32 wide kernels, and its
    # C75xx notes counted by code (C7515: wgmmas serialised; C7519: a
    # warpgroup.arrive injected before registers a wgmma reads)
    report, keep, notes = [], None, {}
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            found = re.search(r"\d(attn_d\w*_wide_(?:tf32_)?kernel|"
                              r"tf32_split_kernel)", line)
            keep = found[1] if found else None
        note = re.search(r"\((C75\d\d)\)", line)
        if note:
            notes[note[1]] = notes.get(note[1], 0) + 1
        elif keep and ("registers" in line or "spill" in line):
            report.append(f"{keep}: {line.strip()}")
    report.append(f"C75xx notes: {notes}")
    dll = ctypes.CDLL(str(lib))
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    tf32 = hasattr(dll, "attention_dq_tf32")
    entries = (("attention_dq", 7), ("attention_dkdv", 8)) + (
        (("attention_dq_tf32", 11), ("attention_dkdv_tf32", 14)) if tf32
        else ())
    for name, pointers in entries:
        getattr(dll, name).argtypes = [ctypes.c_void_p] * pointers + tail
        getattr(dll, name).restype = ctypes.c_int
    return dll, tf32, report


def _launchers(dll, tf32, args, outs, scale):
    """{"dq": fn, "dkdv": fn}: one launch each on the current stream,
    raising if the entry refused it."""
    import torch

    from boosted_detr_torch.ops import attention as A

    q, k, v, g, lse, delta = args
    bh, tq, d = q.shape
    tk = k.shape[1]
    ptrs = [t.data_ptr() for t in args]

    def call(name, *extra, scratch=()):
        def launch():
            stream = torch.cuda.current_stream().cuda_stream
            rc = getattr(dll, name)(*ptrs, *extra, stream)
            if rc != 0:
                raise RuntimeError(f"{name}: error {rc}")
        # the scratch lives as long as the launcher: its pointers are in
        # ``extra``, and freed memory would go to the next allocation
        launch.scratch = scratch
        return launch

    if tf32:
        dq_scratch = A._tf32_scratch(k, 2, 1)
        dkdv_scratch = A._tf32_scratch(q, 2, 2)
        return {"dq": call("attention_dq_tf32", outs[0].data_ptr(),
                           *(t.data_ptr() for t in dq_scratch), bh, tq, tk,
                           d, 0, ctypes.c_float(scale), scratch=dq_scratch),
                "dkdv": call("attention_dkdv_tf32", outs[1].data_ptr(),
                             outs[2].data_ptr(),
                             *(t.data_ptr() for t in dkdv_scratch), bh, tq,
                             tk, d, 0, ctypes.c_float(scale),
                             scratch=dkdv_scratch)}
    return {"dq": call("attention_dq", outs[0].data_ptr(), bh, tq, tk, d, 0,
                       ctypes.c_float(scale)),
            "dkdv": call("attention_dkdv", outs[1].data_ptr(),
                         outs[2].data_ptr(), bh, tq, tk, d, 0,
                         ctypes.c_float(scale))}


def main(argv) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("sources", nargs="*", type=Path)
    parser.add_argument("--variants", nargs="*", default=[],
                        choices=sorted(VARIANTS))
    parser.add_argument("--shapes", nargs="*", default=None,
                        help="BH,Tq,Tk,D in place of SHAPES")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_f32_backward: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import attention as A

    shapes = ([tuple(map(int, s.split(","))) for s in args.shapes]
              if args.shapes else SHAPES)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    builds = []
    for source in args.sources or [SOURCE]:
        name = str(source.resolve().relative_to(ROOT)
                   if source.resolve().is_relative_to(ROOT) else source)
        builds.append((name, "as is", source.resolve().read_text()))
    tree = SOURCE.read_text()
    for variant in args.variants:
        builds.append(("tree", variant, variant_source(tree, variant)))

    def build(job):
        k, (_, _, text) = job
        try:
            return _build(text, str(k))
        except RuntimeError as err:  # a variant that nvcc refuses
            return err

    with ThreadPoolExecutor(max_workers=len(builds)) as pool:  # nvcc at once
        built = list(pool.map(build, enumerate(builds)))
    libs = []
    for (name, tag, _), result in zip(builds, built):
        if isinstance(result, RuntimeError):
            if tag == "as is":
                raise result
            print(f"{name} ({tag}): not built: {str(result)[:2000]}",
                  flush=True)
            continue
        dll, tf32, report = result
        print(f"{name} ({tag}): ptxas:", json.dumps(report), flush=True)
        libs.append((name, tag, dll, tf32))
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for seed, (bh, tq, tk, d) in enumerate(shapes):
        q, k, v, g, g_lse = cs._attention_inputs(bh, tq, tk, d,
                                                 torch.float32, 70 + seed)
        out, lse = A.attention_fwd_reference(q, k, v)
        delta = (g * out).sum(-1) - g_lse
        plain = (A.attention_dq_reference(q, k, v, g, lse, delta),
                 *A.attention_dkdv_reference(q, k, v, g, lse, delta))
        padded = (*A._padded(q, k, v, g), lse, delta)
        scale = A._scale(d)
        emulated = (A.attention_dq_emulation(*padded, scale=scale),
                    *A.attention_dkdv_emulation(*padded, scale=scale))
        emulated = tuple(t[..., :d] for t in emulated)
        for name, tag, dll, tf32 in libs:
            outs = [torch.empty_like(padded[i]) for i in (0, 1, 2)]
            launch = _launchers(dll, tf32, padded, outs, scale)
            for kind, parts in (("dq", (0,)), ("dkdv", (1, 2))):
                launch[kind]()
                torch.cuda.synchronize()
                first = [outs[i][..., :d].clone() for i in parts]
                launch[kind]()
                torch.cuda.synchronize()
                row = {"source": name, "build": tag,
                       "kernel": "tf32" if tf32 else "cuda_cores",
                       "kind": kind, "shape": [bh, tq, tk, d],
                       "repeats_bit_for_bit": all(
                           torch.equal(a, outs[i][..., :d])
                           for a, i in zip(first, parts))}
                errs, gates, emu = [], [], []
                for a, i in zip(first, parts):
                    want = plain[i]
                    errs.append((a - want).abs().max().item())
                    big = max(want.abs().max().item(), 1.0)
                    gates.append(bool(
                        ((a - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()
                        and ((a - want).abs()
                             <= 1e-5 * big + 1e-4 * want.abs()).all()))
                    e = emulated[i]
                    emu.append((a - e).abs().max().item()
                               / max(e.abs().max().item(), 1e-30))
                row.update(max_abs_err=max(errs), passes_gates=all(gates))
                if not all(gates):  # where the first launch is off
                    a, want = first[0], plain[parts[0]]
                    idx = ((a - want).abs()
                           > 1e-4 + 1e-4 * want.abs()).nonzero()
                    row["off"] = {
                        "values": len(idx),
                        "heads": sorted(set(idx[:, 0].tolist()))[:16],
                        "row_blocks": sorted(set((idx[:, 1] // 64)
                                                 .tolist()))[:32],
                        "dim_chunks": sorted(set((idx[:, 2] // 32)
                                                 .tolist())),
                        "second_launch_passes": bool(
                            ((outs[parts[0]][..., :d] - want).abs()
                             <= 1e-4 + 1e-4 * want.abs()).all())}
                if tf32:
                    row["emulation_max_rel_to_max"] = max(emu)
                row["ms"] = cs._time_ms(launch[kind], flush)
                row["device_ms"] = cs._time_ms(launch[kind], flush,
                                               spin_cycles=cs.SPIN_CYCLES)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
