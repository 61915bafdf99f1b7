"""The bf16 K3 kernels past D = 128, bit for bit and timed, across trees.

For every shape of ``chip_smoke.K3_SHAPES`` past D = 128 this script draws
bf16 q, k, v and dO from a fixed seed on the card, runs ``attention_fwd``
of the ``boosted_detr_torch`` package of each checkout it is given, forms
the lse and delta in plain float32, runs ``attention_dq`` and
``attention_dkdv``, and prints the sha256 of out, lse, dq, dk and dv with
each kernel's ``ms`` and ``device_ms`` (``chip_smoke._time_ms``). Each
checkout runs in a process of its own and builds its own kernels (into
its own ``build/kernels/``). Give the checkouts in turns, a parent and a
change for example, to compare them on one card:

    python3 probes/k3_wide_bits.py archive/parent . . archive/parent

(no argument: this checkout alone). It prints one line a checkout and
shape, whether every checkout gave the same bits at each shape, and,
where a checkout's forward differs from the first checkout's, the share
of equal bf16 values of out, the largest difference in bf16 ulps and the
largest difference of the lse; then the card's name and power limit. It
exits 1 if a checkout failed.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

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


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of their values, one apart
    for neighbours (+0 and -0 both 0)."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def run_one(root: str, dump: str) -> dict:
    """out and lse of the forward, and dq, dk and dv, of the package under
    ``root`` at every wide shape: their sha256 and the three kernels'
    times. The forward's out and lse go to ``dump`` as ``<shape>.pt``."""
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
        out_k, lse_k = A.attention_fwd(q, k, v)
        torch.cuda.synchronize()
        torch.save({"out": out_k.cpu(), "lse": lse_k.cpu()},
                   os.path.join(dump, f"{i}.pt"))
        logits = (q.float() * d ** -0.5) @ k.float().transpose(1, 2)
        lse = torch.logsumexp(logits, -1)
        o = (torch.softmax(logits, -1) @ v.float()).bfloat16()
        del logits
        delta = (g.float() * o.float()).sum(-1) - g_lse
        args = (q, k, v, g, lse, delta)
        dq = A.attention_dq(*args)
        dk, dv = A.attention_dkdv(*args)
        torch.cuda.synchronize()
        row = {"out": _digest(out_k), "lse": _digest(lse_k.view(torch.int32)
                                                     .view(torch.int16)),
               "dq": _digest(dq), "dk": _digest(dk), "dv": _digest(dv)}
        for name, fn in (("fwd", lambda: A.attention_fwd(q, k, v)),
                         ("dq", lambda: A.attention_dq(*args)),
                         ("dkdv", lambda: A.attention_dkdv(*args))):
            row[f"{name}_ms"] = cs._time_ms(fn, flush)
            row[f"{name}_device_ms"] = cs._time_ms(
                fn, flush, spin_cycles=cs.SPIN_CYCLES)
        out[f"{label} [{bh}, {tq}, {tk}, {d}]"] = row
        print(f"  {root}: {label}: {json.dumps(row)}", flush=True)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print("RESULT " + json.dumps(run_one(sys.argv[2], sys.argv[3])),
              flush=True)
        return 0
    if not torch.cuda.is_available():
        print("k3_wide_bits: no CUDA card", file=sys.stderr)
        return 1
    roots = sys.argv[1:] or [HERE]
    results, failed = [], False
    dumps = tempfile.mkdtemp(prefix="k3_wide_bits_")
    for n, root in enumerate(roots):
        dump = os.path.join(dumps, str(n))
        os.makedirs(dump)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root, dump],
            capture_output=True, text=True, check=False, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if not ln.startswith("RESULT ")]
        print("\n".join(lines), flush=True)
        if proc.returncode != 0:
            print(f"{root}: failed\n{proc.stderr[-3000:]}", flush=True)
            failed = True
            continue
        results.append((root, dump,
                        json.loads(proc.stdout.split("RESULT ")[-1])))
    for i, shape in enumerate(results[0][2] if results else {}):
        for name in ("out", "lse", "dq", "dk", "dv"):
            digests = {r[shape][name] for _, _, r in results}
            print(f"{shape} {name}: "
                  + ("the same bits in every checkout" if len(digests) == 1
                     else f"{len(digests)} different results"), flush=True)
        first = torch.load(os.path.join(results[0][1], f"{i}.pt"))
        for root, dump, r in results[1:]:
            if r[shape]["out"] == results[0][2][shape]["out"]:
                continue
            other = torch.load(os.path.join(dump, f"{i}.pt"))
            ulps = (_ordered(other["out"]) - _ordered(first["out"])).abs()
            print(f"{shape} out of {root} against {results[0][0]}: "
                  f"{(ulps == 0).double().mean().item():.6f} of the values "
                  f"the same bf16, at most {ulps.max().item()} ulps apart; "
                  f"lse at most "
                  f"{(other['lse'] - first['lse']).abs().max().item():.3e} "
                  f"apart", flush=True)
    shutil.rmtree(dumps, ignore_errors=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60).stdout.strip()
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
