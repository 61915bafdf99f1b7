"""K2's time by phase on one card, in cycles of the SM's clock.

``boosted_detr_torch/csrc/lap.cu`` solves each problem in one warp, a
serial chain of Dijkstra steps and augmentation steps. This script builds a
copy of the kernel with ``clock64()`` stamps (``-DLAP_PHASES``: the shipped
build has none) into ``build/probes/``, runs it on K2's cases of
``chip_smoke.py`` (``K2_CASES``) and reports, for each problem, the cycles
of four phases as the first lane of the solving warp sees them:

- prologue: from the kernel's entry until the problem's cost has landed in
  shared memory;
- Dijkstra: the searches, and their count of steps (each loop iteration,
  the one that finds a free column included);
- augmentation: the walks back along ``way``, and their count of steps;
- epilogue: from the end of the last augmentation until the mask is
  written;

and what is left of the total (the setup of each row). Beside it, the
same source built without stamps times the launch by ``chip_smoke.py``'s
two methods (``ms``: from an idle card, L2 flushed; ``device_ms``: the
launch enqueued ahead of a spin on the card), and its ptxas report
(registers, stack frame, spills). Every build's mask is held to the plain
version's.

A source with the ``LAP_PHASES`` hooks (the committed kernel) is built as
it is, and once more with its warp argmin (``__reduce_min_sync`` twice)
swapped for the shuffle butterfly of the kernel's first design
(``SHUFFLE_ARGMIN``, an exact edit). A source without them is taken to be that first
design (one warp copies the cost in, the row duals in shared memory, eight
column slots a lane) and is given the stamps by exact edits (``EDITS``);
the script raises if any edit does not match exactly once. Run on a card from the root of a checkout:

    python3 probes/lap_phases.py [path/to/lap.cu]

It prints the card's name, power limit and SM clocks, and one JSON line a
build and shape.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "boosted_detr_torch" / "csrc" / "lap.cu"
# a problem's record: the cycles of each phase and the steps
FIELDS = ("prologue", "dijkstra", "dijkstra_steps", "augmentation",
          "augmentation_steps", "epilogue", "total")

_BUFFER = """
extern "C" int lap_phase_buffer(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(lap_phase_out, &p, sizeof(p)));
}
"""

# The committed kernel's argmin, and the first design's five rounds of two
# shuffles and a compare-select in its place.
SHUFFLE_ARGMIN = (
    """  // order-preserving key: -0.0 + 0.0 is +0.0, then negative floats
  // flipped whole and positive ones above them
  const unsigned bits = __float_as_uint(__fadd_rn(value, 0.f));
  const unsigned key = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  const unsigned least = __reduce_min_sync(0xffffffffu, key);
  index = __reduce_min_sync(0xffffffffu, key == least ? index : ~0u);
  value = __uint_as_float((least & 0x80000000u) ? (least & 0x7fffffffu)
                                                : ~least);
""",
    """#pragma unroll
  for (int offset = WARP / 2; offset > 0; offset /= 2) {
    const float v = __shfl_xor_sync(0xffffffffu, value, offset);
    const unsigned j = __shfl_xor_sync(0xffffffffu, index, offset);
    if (v < value || (v == value && j < index)) {
      value = v;
      index = j;
    }
  }
""")

# The stamps, put into the kernel that has no hooks of its own.
EDITS = (
    ("#include <cuda_runtime.h>\n",
     "#include <cuda_runtime.h>\n\n__device__ long long* lap_phase_out;\n"),
    ("  const int lane = threadIdx.x;\n",
     "  const long long t_entry = clock64();\n"
     "  long long t_dj = 0, n_dj = 0, t_aug = 0, n_aug = 0;\n"
     "  const int lane = threadIdx.x;\n"),
    ("  for (int r = lane; r < O; r += WARP) s_u[r] = 0.f;\n  __syncwarp();\n",
     "  for (int r = lane; r < O; r += WARP) s_u[r] = 0.f;\n  __syncwarp();\n"
     "  const long long t_landed = clock64();\n"),
    ("    int j0 = virt;\n    for (int step = 0; step < C; ++step) {\n",
     "    int j0 = virt;\n    const long long t_search = clock64();\n"
     "    for (int step = 0; step < C; ++step) {\n      ++n_dj;\n"),
    ("      j0 = best_j;\n    }\n",
     "      j0 = best_j;\n    }\n"
     "    const long long t_searched = clock64();\n"
     "    t_dj += t_searched - t_search;\n"),
    ("    for (int step = 0; step < C && j0 != virt; ++step) {\n",
     "    for (int step = 0; step < C && j0 != virt; ++step) {\n"
     "      ++n_aug;\n"),
    ("      j0 = j1;\n    }\n  }\n",
     "      j0 = j1;\n    }\n    t_aug += clock64() - t_searched;\n  }\n"
     "  const long long t_solved = clock64();\n"),
    ("    dst[e] = (r < n && s_match[j] == r) ? 1.f : 0.f;\n  }\n}\n",
     "    dst[e] = (r < n && s_match[j] == r) ? 1.f : 0.f;\n  }\n"
     "  const long long t_end = clock64();\n"
     "  if (lane == 0 && lap_phase_out != nullptr) {\n"
     "    long long* rec = lap_phase_out + 8LL * b;\n"
     "    rec[0] = t_landed - t_entry; rec[1] = t_dj; rec[2] = n_dj;\n"
     "    rec[3] = t_aug; rec[4] = n_aug; rec[5] = t_end - t_solved;\n"
     "    rec[6] = t_end - t_entry;\n"
     "  }\n}\n"),
)


def stamped_source(src: str) -> str:
    """``src`` with the stamps: as it is when it has the hooks, else with
    ``EDITS``, each of which must match exactly once."""
    if "LAP_PHASES" in src:
        return src
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"the source has {src.count(old)} matches of "
                               f"the edit starting {old[:50]!r}")
        src = src.replace(old, new)
    return src + _BUFFER


def _build(text: str, tag: str, defines) -> tuple:
    from boosted_detr_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"lap_{tag}.cu"
    cu.write_text(text)
    lib = out_dir / f"liblap_{tag}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), *(f"-D{d}" for d in defines),
                           "-o", str(lib), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr}")
    report = [s.strip() for s in (proc.stdout + proc.stderr).splitlines()
              if "registers" in s or "spill" in s or "stack frame" in s
              or "Compiling entry" in s]
    dll = ctypes.CDLL(str(lib))
    dll.lap_solve.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                              + [ctypes.c_void_p])
    dll.lap_solve.restype = ctypes.c_int
    return dll, report


def _phases(recs, steps_of):
    """The records of a launch, summed over its problems, and the slowest
    problem's."""
    tot = {f: int(recs[:, i].sum()) for i, f in enumerate(FIELDS)}
    slow = int(recs[:, 6].argmax())
    one = {f: int(recs[slow, i]) for i, f in enumerate(FIELDS)}
    one["rest"] = one["total"] - sum(one[f] for f in (
        "prologue", "dijkstra", "augmentation", "epilogue"))
    return {
        # the slowest problem's searches over its relaxing steps (the
        # plain version's count: the steps that find a free column and
        # stop cost their share too)
        "cycles_per_relaxing_step": one["dijkstra"] / max(1, steps_of[slow]),
        "cycles_per_dijkstra_step": tot["dijkstra"] / max(
            1, tot["dijkstra_steps"]),
        "cycles_per_augmentation_step": tot["augmentation"] / max(
            1, tot["augmentation_steps"]),
        "prologue_cycles_median": sorted(recs[:, 0].tolist())[len(recs) // 2],
        "epilogue_cycles_median": sorted(recs[:, 5].tolist())[len(recs) // 2],
        "slowest_problem": {"index": slow, **one,
                            "plain_version_steps": steps_of[slow]},
    }


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("lap_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from boosted_detr_torch.ops import lap as L

    source = Path(argv[0]) if argv else SOURCE
    src = source.read_text()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    variants = [("", src)]
    if "LAP_PHASES" in src:
        old, new = SHUFFLE_ARGMIN
        if src.count(old) != 1:
            raise RuntimeError("the source's argmin is not the one this "
                               "script swaps")
        variants.append(("shuffle", src.replace(old, new)))
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for tag, text in variants:
        name = f"{source.parent.name}{'_' + tag if tag else ''}"
        timed, report = _build(text, f"{name}_timed", ())
        print(f"{name}: ptxas (no stamps):", *report, flush=True)
        stamped, _ = _build(stamped_source(text), f"{name}_stamped",
                            ("LAP_PHASES",))
        stamped.lap_phase_buffer.argtypes = [ctypes.c_void_p]
        for b, o, p, seed, edges in cs.K2_CASES:
            cost_np, n_np = cs._lap_inputs(b, o, p, seed, edges)
            cost = torch.from_numpy(cost_np).cuda()
            n = torch.from_numpy(n_np).cuda()
            out = torch.empty_like(cost)
            recs = torch.zeros((b, 8), dtype=torch.int64, device="cuda")

            def launch(lib):
                rc = lib.lap_solve(cost.data_ptr(), n.data_ptr(),
                                   out.data_ptr(), b, o, p,
                                   torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"launch refused ({rc})")

            row = {"source": str(source.relative_to(ROOT)
                                 if source.is_relative_to(ROOT) else source),
                   "build": tag or "as is", "shape": [b, o, p],
                   "edges": edges}
            try:
                launch(timed)
            except RuntimeError as err:
                row["refused"] = str(err)
                print(json.dumps(row), flush=True)
                continue
            torch.cuda.synchronize()
            want = L.hungarian_lap_reference(cost, n)
            if not torch.equal(out, want):
                raise AssertionError(f"{name} {row['shape']}: the mask is "
                                     f"not the plain version's")
            steps = []
            for i in range(b):
                L.hungarian_lap_reference.relaxations = 0
                L.hungarian_lap_reference(cost[i:i + 1], n[i:i + 1])
                steps.append(L.hungarian_lap_reference.relaxations)
            row["ms"] = cs._time_ms(lambda: launch(timed), flush)
            row["device_ms"] = cs._time_ms(lambda: launch(timed), flush,
                                           spin_cycles=cs.SPIN_CYCLES)
            if stamped.lap_phase_buffer(recs.data_ptr()) != 0:
                raise RuntimeError("lap_phase_buffer failed")
            for _ in range(3):  # the last launch's records stay
                launch(stamped)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{name} {row['shape']}: the stamped "
                                     f"build's mask is not the plain "
                                     f"version's")
            row.update(_phases(recs[:, :7].cpu().numpy(), steps))
            stamped.lap_phase_buffer(None)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
