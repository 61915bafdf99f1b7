"""How closely orders of float32 sums reproduce the K1-fwd tensor-core
kernel's outputs, on one card.

``csrc/patchify.cu``'s ``patchify_fwd_mma_kernel`` sums each MMA step's 16
products from zero on the tensor cores and adds the step onto a running
float32 sum in k order. Its plain version (``patchify_conv_reference``)
takes one float32 matmul of the rounded values. The two round some outputs
to other bf16 values, and those one-ulp differences are what moves
``chip_smoke.py``'s one-step loss check (``probes/loss_check_noise.py``).
This script counts, at the bf16 stems of ``chip_smoke.K1_CASES``, the
outputs of the kernel (float32 and bf16) that differ from:

- ``plain``: the plain version;
- ``steps_rn``: float32 matmuls of each 16-wide k step, added in k order;
- ``steps_exact_rn``: each step's sum exact (float64), rounded to nearest
  float32, the steps added in k order in float32;
- ``steps_exact_rz``: the same, each step's sum rounded toward zero.

Run on a card from the root of a checkout:

    python3 probes/k1_sum_order.py

It prints the card's name and power limit and one JSON line a shape.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

STEP = 16


def _toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """float64 -> float32 rounded toward zero."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def emulations(patches: torch.Tensor, w: torch.Tensor):
    """{name: float32 [M, N]} for each order of sums."""
    a, b = patches.float(), w.float()
    out = {"plain": a @ b}
    k = a.shape[1]
    for name in ("steps_rn", "steps_exact_rn", "steps_exact_rz"):
        acc = None
        for s in range(0, k, STEP):
            if name == "steps_rn":
                part = a[:, s:s + STEP] @ b[s:s + STEP]
            else:
                exact = a[:, s:s + STEP].double() @ b[s:s + STEP].double()
                part = (exact.float() if name == "steps_exact_rn"
                        else _toward_zero(exact))
            acc = part if acc is None else acc + part
        out[name] = acc
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_sum_order: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from boosted_detr_torch.ops import patchify as P

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for patch, c_out, dtype, seed, res in cs.K1_CASES:
        if dtype != torch.bfloat16 or patch == 4:
            continue  # the tensor-core stems only
        x, w = cs._patchify_inputs(patch, c_out, dtype, seed, res)
        got32 = P.patchify_conv(x, w, out_dtype=torch.float32, clip01=True)
        got16 = P.patchify_conv(x, w, clip01=True)
        patches, _ = P._patch_matrix(x, patch, dtype, True)
        t0 = time.perf_counter()
        emus = emulations(patches, w.reshape(-1, c_out))
        torch.cuda.synchronize()
        row = {"shape": cs._patchify_label(patch, c_out, dtype, res),
               "outputs": got32.numel(),
               "emulations_s": time.perf_counter() - t0}
        k32, k16 = got32.reshape(-1, c_out), got16.reshape(-1, c_out)
        for name, emu in emus.items():
            row[name] = {
                "float32_differ": int((emu != k32).sum()),
                "bf16_differ": int((emu.to(dtype) != k16).sum()),
                "max_abs_float32": (emu - k32).abs().max().item()}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
