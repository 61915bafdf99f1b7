"""Repeats ``chip_smoke.py``'s first K1 check and counts its verdict twice.

The first case of the kernel phase holds the stem's forward (640 px, P=8,
128 channels, bf16 weights) against its plain version. This script runs
that case ``runs`` times, each on inputs drawn from its own seed, and for
each run counts the values outside the case's tolerance both with a
reduction on the card and on the host, from the same two tensors. It
reports every run in which the two counts or the two maxima differ, a
count exceeds the tensor's size, any value lies outside the tolerance, or
a second copy of the kernel's output to the host differs from the first.

Run on a card from the root of a checkout:

    python3 probes/k1_check_repeat.py [runs]    # default 200

It prints one line a flagged run, then the number of runs and of flagged
runs, and the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from boosted_detr_torch.ops import patchify  # noqa: E402

ATOL, RTOL = 1e-5, 2.0 ** -7  # the bf16 case's tolerance in chip_smoke.py


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_check_repeat: no CUDA card", file=sys.stderr)
        return 1
    runs = int(sys.argv[1]) if sys.argv[1:] else 200
    t0 = time.perf_counter()
    chip_smoke.phase_build()
    patch, c_out, dtype, _, res = chip_smoke.K1_CASES[0]
    flagged = 0
    for seed in range(runs):
        x, w = chip_smoke._patchify_inputs(patch, c_out, dtype, seed, res)
        out = patchify.patchify_conv(x, w, clip01=True)
        ref = patchify.patchify_conv_reference(x, w, clip01=True)
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        err = (o - r).abs()
        card = (err > ATOL + RTOL * r.abs()).sum().item()
        card_max = err.max().item()
        oh, rh = o.cpu(), r.cpu()
        eh = (oh - rh).abs()
        host = (eh > ATOL + RTOL * rh.abs()).sum().item()
        host_max = eh.max().item()
        stable = torch.equal(oh, out.float().cpu())
        if (card != host or card > out.numel() or host or not stable
                or card_max != host_max):
            flagged += 1
            print(f"run {seed}: card count {card}, host count {host}, card "
                  f"max {card_max}, host max {host_max}, of {out.numel()} "
                  f"values; output stable {stable}", flush=True)
    print(f"{runs} runs, {flagged} flagged, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
