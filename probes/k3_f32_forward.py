"""K3's float32 forward past D = 128 on one card: the TF32 kernel
(``attn_fwd_wide_tf32_kernel<D>`` at a padded 256 and 384, with the
``tf32_split_kernel`` pass before it) beside the CUDA-core kernel it
replaced there (``attn_fwd_wide_kernel``), each source built and timed in
one process; and, with ``model``, the CPU model of the tensor cores'
truncating adds that chose how the kernel sums P.V.

Each ``attention.cu`` given (a parent's, from ``git archive`` unpacked into
a directory that ``.gitignore`` lists, and this tree's) is built with nvcc
into ``build/probes/`` and called through ctypes: a source with the
``attention_fwd_tf32`` entry through it at a padded 256 and 384 (the split
pass and the kernel, scratch allocated once), any other through
``attention_fwd``. At every shape (``chip_smoke.py``'s float32 rows past
128 by default: [32, 1600, 1600, 256], vit_l16_h4's blocks, [16, 400, 400,
160] padded to 256 and [8, 400, 400, 384], and [16, 1600, 1600, 384]) it
prints one JSON line a build: ``ms`` (from an idle card, L2 flushed) and
``device_ms`` (the launch enqueued ahead of a spin on the card), as
``chip_smoke.py`` times them; the largest difference of out and of the
lse from the plain version (``attention_fwd_reference``) and whether both
pass the float32 gates (out 1e-5 of the largest value / 1e-4, the lse
1e-5 / 1e-5); for the TF32 builds the largest difference of out from this
tree's emulation relative to its largest value, the lse's, and whether a
second launch gave the same bits. A line a shape gives SDPA's float32
``ms`` (``scaled_dot_product_attention`` on [1, BH, T, D] views) and the
three-TF32 bound. Then ptxas's registers, spills and C75xx notes of each
build's float32 wide forward, and its blocks an SM.

``--variants`` builds this tree's source once more for each variant named,
by exact edits of the shipped source (``VARIANTS``; the code of a design
the kernel does not take is carried here, not in the kernel): ``rows_64``
(``Tf32FwdPlan``'s ``WGS`` 2 -> 1 at D = 256 and ``TF32_FWD_STAGES_256``
8 -> 12: blocks of one warpgroup of 64 rows, one block an SM),
``rows_64_stages_5`` (64 rows, 5 stages: 105 KB a block, two blocks an
SM), ``stages_12`` and ``stages_6`` (8 -> 12 or 6 at 128 rows),
``stages_384_6`` and ``stages_384_3`` (``TF32_FWD_STAGES_384`` 4 -> 6 or
3), ``direct`` (P.V added straight into the output, rescaled first, in
place of the tile sums), ``shared_s`` (at D = 384 both warpgroups sum S
over all D from their own stream of k, no exchange of halves). Run on a
card from the root of a checkout:

    python3 probes/k3_f32_forward.py [path/to/attention.cu ...]
        [--variants rows_64 rows_64_stages_5 stages_12 stages_6
         stages_384_6 stages_384_3 direct shared_s]
        [--shapes BH,Tq,Tk,D ...]

It prints the card's name, power limit and SM clocks first. On the CPU,

    python3 probes/k3_f32_forward.py model

runs the model: each wgmma k8 step adds its 8 exact products into the
float32 sum and truncates toward zero; it prints, for P.V added straight
into the output against a zero-started sum a tile and 32-dim unit folded
as acc alpha + tile_sum, and S in one sum against S in two halves, how
far out and the lse lie from a float64 reference and from the emulation
(which rounds), at a few shapes of 64 query rows.
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
SHAPES = ((32, 1600, 1600, 256), (16, 400, 400, 160), (8, 400, 400, 384),
          (16, 1600, 1600, 384))
ROWS_64 = ("  static constexpr int WGS = 2;\n",
           "  static constexpr int WGS = SPLIT_DIMS ? 2 : 1;\n")
# the kernel's P.V: each unit's products summed from zero, folded into acc
TILE_SUMS = """\
    float part[2][16];
#pragma unroll
    for (int h = 0; h < P::OWN_UNITS; ++h) {
      const unsigned char* unit = unit_of(base + P::S_SLABS + h);
      wgmma_fence();
      tf32_over_rows(part[h % 2], hi, lo, unit, true);
      wgmma_commit();
      if (h > 0) {
        wgmma_wait<TF32_IN_FLIGHT>();
        wgmma_hold(part[(h - 1) % 2]);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          acc[h - 1][e] =
              fmaf(acc[h - 1][e], alpha[e % 4 / 2], part[(h - 1) % 2][e]);
        release(base + P::S_SLABS + h - 1);
      }
    }
    wgmma_wait<0>();
    constexpr int LAST = P::OWN_UNITS - 1;
    wgmma_hold(part[LAST % 2]);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      acc[LAST][e] = fmaf(acc[LAST][e], alpha[e % 4 / 2], part[LAST % 2][e]);
    release(base + UNITS - 1);
"""
# ``direct``: acc rescaled, then the products added straight into it
DIRECT = """\
    float(&acc_flat)[P::OWN_UNITS * 16] =
        reinterpret_cast<float(&)[P::OWN_UNITS * 16]>(acc);
#pragma unroll
    for (int i2 = 0; i2 < P::OWN_UNITS * 16; ++i2)
      acc_flat[i2] *= alpha[i2 % 4 / 2];
    wgmma_hold(acc_flat);
#pragma unroll
    for (int h = 0; h < P::OWN_UNITS; ++h) {
      const unsigned char* unit = unit_of(base + P::S_SLABS + h);
      wgmma_fence();
      tf32_over_rows(acc[h], hi, lo, unit);
      wgmma_commit();
      if (h > 0) {
        wgmma_wait<TF32_IN_FLIGHT>();
        release(base + P::S_SLABS + h - 1);
      }
    }
    wgmma_wait<0>();
    wgmma_hold(acc_flat);
    release(base + UNITS - 1);
"""
# ``shared_s``: every warpgroup's S over all slabs, the halves' exchange gone
SHARED_S = (
    ("  static constexpr int S_SLABS = SPLIT_DIMS ? SLABS / 2 : SLABS;",
     "  static constexpr int S_SLABS = SLABS;"),
    ("  static constexpr int HALVES_BYTES = SPLIT_DIMS ? 2 * WGS * 128 * 16 * "
     "4 : 0;", "  static constexpr int HALVES_BYTES = 0;"),
    ("  const int s0 = P::SPLIT_DIMS ? wg * P::S_SLABS : 0;",
     "  const int s0 = 0;"),
    ("    if constexpr (P::SPLIT_DIMS) {\n      // both halves",
     "    if constexpr (false) {\n      // both halves"))


def _stages(n, d=256):
    return (f"constexpr int TF32_FWD_STAGES_{d} = {8 if d == 256 else 4};",
            f"constexpr int TF32_FWD_STAGES_{d} = {n};")


VARIANTS = {
    "rows_64": (ROWS_64, _stages(12)),
    "rows_64_stages_5": (ROWS_64, _stages(5)),
    "stages_12": (_stages(12),),
    "stages_6": (_stages(6),),
    "stages_384_6": (_stages(6, 384),),
    "stages_384_3": (_stages(3, 384),),
    "direct": ((TILE_SUMS, DIRECT),),
    "shared_s": SHARED_S,
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


# ---------------------------------------------------------------- the model

def _model_rows():
    """The CPU model's rows (see the module's docstring)."""
    import numpy as np
    import torch

    mask = -(1 << 13)

    def tf32(x):
        return (x.float().contiguous().view(torch.int32) & mask).view(
            torch.float32)

    def parts(x):
        hi = tf32(x)
        return hi.double(), tf32(x.float() - hi).double()

    def trunc32(x):  # float64 -> float32 toward zero, kept as float64
        f = x.float()
        over = f.double().abs() > x.abs()
        return torch.where(over, torch.nextafter(f, torch.zeros_like(f)),
                           f).double()

    def rn32(x):
        return x.float().double()

    def product(a, b, acc, trunc):
        (ah, al), (bh, bl) = parts(a), parts(b)
        add = trunc32 if trunc else rn32
        for c0 in range(0, a.shape[-1], 8):
            c = slice(c0, c0 + 8)
            for x, y in ((ah, bh), (ah, bl), (al, bh)):
                acc = add(acc + x[..., c] @ y[..., c, :])
        return acc

    def forward(q, k, v, tile_sums, split_s, trunc=True):
        rows, d = q.shape
        scale = 1.0 / np.sqrt(d)
        scale2 = np.float32(scale * 1.4426950408889634)
        m = torch.full((rows, 1), -1e30, dtype=torch.float32)
        denom = torch.zeros((rows, 1), dtype=torch.float32)
        acc = torch.zeros((rows, d), dtype=torch.float64)
        for k0 in range(0, k.shape[0], 32):
            kt, vt = k[k0:k0 + 32], v[k0:k0 + 32]
            zero = torch.zeros((rows, kt.shape[0]), dtype=torch.float64)
            if split_s:
                h = d // 2
                s = (product(q[:, :h], kt[:, :h].T, zero, trunc).float()
                     + product(q[:, h:], kt[:, h:].T, zero, trunc).float())
            else:
                s = product(q, kt.T, zero, trunc).float()
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp2((m - m_new) * scale2)
            p = torch.exp2(s * scale2 - m_new * scale2)
            denom = denom * alpha + p.sum(-1, keepdim=True)
            m = m_new
            if not tile_sums:
                acc = rn32(acc * alpha.double())
            for u in range(0, d, 32):
                if tile_sums:
                    part = product(p, vt[:, u:u + 32], torch.zeros(
                        (rows, 32), dtype=torch.float64), trunc)
                    acc[:, u:u + 32] = rn32(acc[:, u:u + 32]
                                            * alpha.double() + part)
                else:
                    acc[:, u:u + 32] = product(p, vt[:, u:u + 32],
                                               acc[:, u:u + 32], trunc)
        denom = denom.clamp_min(1e-30)
        return (acc.float() * (1.0 / denom),
                (m * np.float32(scale) + torch.log(denom)).squeeze(-1))

    rng = np.random.default_rng(0)
    for rows, keys, d in ((64, 1600, 256), (64, 1600, 384), (64, 400, 384),
                          (70, 130, 256), (64, 1, 256)):
        q, k, v = (torch.from_numpy(rng.standard_normal((n, d)).astype(
            np.float32)) for n in (rows, keys, keys))
        s = q.double() @ k.double().T / np.sqrt(d)
        top = s.amax(-1, keepdim=True)
        p = torch.exp(s - top)
        ref = (p @ v.double()) / p.sum(-1, keepdim=True)
        ref_lse = (top + torch.log(p.sum(-1, keepdim=True))).squeeze(-1)
        big = ref.abs().max().item()
        emu = forward(q, k, v, True, False, trunc=False)[0]
        for tile_sums in (False, True):
            for split_s in (False, True):
                out, lse = forward(q, k, v, tile_sums, split_s)
                err = out.double() - ref
                yield {"shape": [rows, keys, d], "tile_sums": tile_sums,
                       "split_s": split_s,
                       "out_off_ref_of_max": err.abs().max().item() / big,
                       "outside_float32_gate": int((err.abs() > 1e-5 + 1e-4
                                                    * ref.abs()).sum()),
                       "lse_off_ref": (lse.double() - ref_lse).abs().max()
                       .item(),
                       "off_emulation_of_max": (out - emu).abs().max().item()
                       / big}


# ----------------------------------------------------------------- the card

def _build(text: str, tag: str):
    from boosted_detr_torch.ops import build

    out_dir = build.BUILD_DIR.parent / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"attention_fwd_{tag}.cu"
    cu.write_text(text)
    lib = out_dir / f"libattention_fwd_{tag}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stderr[-4000:]}")
    # ptxas's registers and spills of the float32 wide forward, and its
    # C75xx notes counted by code (C7515: wgmmas serialised)
    report, keep, notes = [], None, {}
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            found = re.search(r"\d(attn_fwd_wide_(?:tf32_)?kernel(?:ILi\d+E)?)",
                              line)
            keep = found[1] if found else None
        note = re.search(r"\((C75\d\d)\).*?\d(attn_\w+?_kernel)", line)
        if note:
            key = f"{note[1]} {note[2]}"
            notes[key] = notes.get(key, 0) + 1
        elif keep and ("registers" in line or "spill" in line):
            report.append(f"{keep}: {line.strip()}")
    report.append(f"C75xx notes: {notes}")
    dll = ctypes.CDLL(str(lib))
    tail = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    tf32 = hasattr(dll, "attention_fwd_tf32")
    for name, pointers in (("attention_fwd", 5),) + (
            (("attention_fwd_tf32", 8),) if tf32 else ()):
        getattr(dll, name).argtypes = [ctypes.c_void_p] * pointers + tail
        getattr(dll, name).restype = ctypes.c_int
    if hasattr(dll, "attention_occupancy"):
        dll.attention_occupancy.argtypes = ([ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)] * 2)
    return dll, tf32, report


def _occupancy(dll, d):
    """(blocks an SM, shared memory) of the build's float32 forward at d,
    where its occupancy entry takes it; else None."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    if not hasattr(dll, "attention_occupancy"):
        return None
    rc = dll.attention_occupancy(0, d, 0, ctypes.byref(blocks),
                                 ctypes.byref(smem))
    return (blocks.value, smem.value) if rc == 0 else None


def _launcher(dll, tf32, q, k, v, out, lse, scale):
    """One forward launch on the current stream, raising if the entry
    refused it; the TF32 entry with its scratch, allocated once and kept
    alive by the launcher (a freed scratch's memory would go to the next
    allocation while launches still write it)."""
    import torch

    from boosted_detr_torch.ops import attention as A

    bh, tq, d = q.shape
    tk = k.shape[1]
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse)]
    scratch = A._tf32_scratch(k, 1, 1) if tf32 else ()
    name = "attention_fwd_tf32" if tf32 else "attention_fwd"

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(dll, name)(*ptrs, *(t.data_ptr() for t in scratch),
                                bh, tq, tk, d, 0, ctypes.c_float(scale),
                                stream)
        if rc != 0:
            raise RuntimeError(f"{name}: error {rc}")

    launch.scratch = scratch
    return launch


def main(argv) -> int:
    import argparse

    if argv[:1] == ["model"]:
        for row in _model_rows():
            print(json.dumps(row), flush=True)
        return 0
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("sources", nargs="*", type=Path)
    parser.add_argument("--variants", nargs="*", default=[],
                        choices=sorted(VARIANTS))
    parser.add_argument("--shapes", nargs="*", default=None,
                        help="BH,Tq,Tk,D in place of SHAPES")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_f32_forward: no CUDA device", file=sys.stderr)
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
        i, (_, _, text) = job
        try:
            return _build(text, str(i))
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
        occ = {d: _occupancy(dll, d) for d in A.TF32_FORWARD_HEAD_DIMS}
        print(f"{name} ({tag}): ptxas:", json.dumps(report),
              "blocks an SM, shared memory:", json.dumps(occ), flush=True)
        libs.append((name, tag, dll, tf32))
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for seed, (bh, tq, tk, d) in enumerate(shapes):
        q, k, v = cs._attention_inputs(bh, tq, tk, d, torch.float32,
                                       90 + seed)[:3]
        want, want_lse = A.attention_fwd_reference(q, k, v)
        qp, kp, vp = A._padded(q, k, v)
        padded = qp.shape[-1]
        scale = A._scale(d)
        emu, emu_lse = A.attention_fwd_emulation(qp, kp, vp, scale=scale)
        emu = emu[..., :d]
        q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
        pairs = bh * tq * tk * d
        print(json.dumps({
            "shape": [bh, tq, tk, d], "padded": padded,
            "sdpa_ms": cs._time_ms(lambda: sdpa(q4, k4, v4), flush),
            "bound_ms": 3 * 4 * pairs / cs.TF32_OPS_PER_S * 1e3,
            "bound_cuda_core_ms": 4 * pairs / cs.PEAK_OPS_PER_S[
                torch.float32] * 1e3}), flush=True)
        for name, tag, dll, tf32 in libs:
            on_tf32 = tf32 and padded in A.TF32_FORWARD_HEAD_DIMS
            out = torch.empty_like(qp)
            lse = torch.empty(q.shape[:2], device="cuda")
            launch = _launcher(dll, on_tf32, qp, kp, vp, out, lse, scale)
            launch()
            torch.cuda.synchronize()
            first = (out[..., :d].clone(), lse.clone())
            launch()
            torch.cuda.synchronize()
            got = first[0]
            big = want.abs().max().item()
            err = (got - want).abs()
            lse_err = (first[1] - want_lse).abs()
            row = {"source": name, "build": tag,
                   "kernel": "tf32" if on_tf32 else "cuda_cores",
                   "shape": [bh, tq, tk, d],
                   "repeats_bit_for_bit": bool(
                       torch.equal(first[0], out[..., :d])
                       and torch.equal(first[1], lse)),
                   "max_abs_err": err.max().item(),
                   "lse_max_abs_err": lse_err.max().item(),
                   "passes_gates": bool(
                       (err <= 1e-5 * max(big, 1.0) + 1e-4 * want.abs())
                       .all() and (lse_err <= 1e-5 + 1e-5 * want_lse.abs())
                       .all())}
            if on_tf32:
                row["emulation_max_rel_to_max"] = (
                    (got - emu).abs().max().item() / emu.abs().max().item())
                row["emulation_lse_max_abs"] = (
                    (first[1] - emu_lse).abs().max().item())
            row["ms"] = cs._time_ms(launch, flush)
            row["device_ms"] = cs._time_ms(launch, flush,
                                           spin_cycles=cs.SPIN_CYCLES)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
