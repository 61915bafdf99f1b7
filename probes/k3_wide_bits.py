"""The bf16 K3 gradients past D = 128, bit for bit and timed, across trees.

For every shape of ``chip_smoke.K3_SHAPES`` past D = 128 this script draws
bf16 q, k, v and dO from a fixed seed on the card, forms the lse and delta
in plain float32, runs ``attention_dq`` and ``attention_dkdv`` of the
``boosted_detr_torch`` package of each checkout it is given, and prints
the sha256 of dq, dk and dv with each kernel's ``ms`` and ``device_ms``
(``chip_smoke._time_ms``). Each checkout runs in a process of its own and
builds its own kernels (into its own ``build/kernels/``). Give the
checkouts in turns, a parent and a change for example, to compare them on
one card:

    python3 probes/k3_wide_bits.py archive/parent . . archive/parent

(no argument: this checkout alone). It prints one line a checkout and
shape, whether every checkout gave the same bits at each shape, and the
card's name and power limit; it exits 1 if a checkout failed.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_SEED = 300


def _chip_smoke():
    """This checkout's chip_smoke.py, loaded by path (a checkout given as
    an argument may have its own)."""
    spec = importlib.util.spec_from_file_location(
        "probe_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy()
                          .tobytes()).hexdigest()


def run_one(root: str) -> dict:
    """dq, dk and dv of the package under ``root`` at every wide shape:
    their sha256 and the two kernels' times."""
    sys.path.insert(0, os.path.abspath(root))
    from boosted_detr_torch.ops import attention as A

    assert os.path.abspath(A.__file__).startswith(os.path.abspath(root))
    cs = _chip_smoke()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    out = {}
    wide = [s for s in cs.K3_SHAPES if s[-1] > 128]
    for i, (label, bh, tq, tk, d) in enumerate(wide):
        gen = torch.Generator(device="cuda").manual_seed(FIRST_SEED + i)
        q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda")
                      .bfloat16() for t in (tq, tk, tk, tq))
        g_lse = torch.randn((bh, tq), generator=gen, device="cuda")
        logits = (q.float() * d ** -0.5) @ k.float().transpose(1, 2)
        lse = torch.logsumexp(logits, -1)
        o = (torch.softmax(logits, -1) @ v.float()).bfloat16()
        del logits
        delta = (g.float() * o.float()).sum(-1) - g_lse
        args = (q, k, v, g, lse, delta)
        dq = A.attention_dq(*args)
        dk, dv = A.attention_dkdv(*args)
        torch.cuda.synchronize()
        row = {"dq": _digest(dq), "dk": _digest(dk), "dv": _digest(dv)}
        for name, fn in (("dq", lambda: A.attention_dq(*args)),
                         ("dkdv", lambda: A.attention_dkdv(*args))):
            row[f"{name}_ms"] = cs._time_ms(fn, flush)
            row[f"{name}_device_ms"] = cs._time_ms(
                fn, flush, spin_cycles=cs.SPIN_CYCLES)
        out[f"{label} [{bh}, {tq}, {tk}, {d}]"] = row
        print(f"  {root}: {label}: {json.dumps(row)}", flush=True)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("RESULT " + json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("k3_wide_bits: no CUDA card", file=sys.stderr)
        return 1
    roots = sys.argv[1:] or [HERE]
    results, failed = [], False
    for root in roots:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True, check=False, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if not ln.startswith("RESULT ")]
        print("\n".join(lines), flush=True)
        if proc.returncode != 0:
            print(f"{root}: failed\n{proc.stderr[-3000:]}", flush=True)
            failed = True
            continue
        results.append((root, json.loads(proc.stdout.split("RESULT ")[-1])))
    for shape in (results[0][1] if results else {}):
        for name in ("dq", "dk", "dv"):
            digests = {r[shape][name] for _, r in results}
            print(f"{shape} {name}: "
                  + ("the same bits in every checkout" if len(digests) == 1
                     else f"{len(digests)} different results"), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60).stdout.strip()
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
