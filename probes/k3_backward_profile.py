"""K3's backward alone, kernel by kernel, from a profile, across trees.

For the 1280 encoder's [64, 1600, 1600, 32] and ViT-p16's blocks'
[48, 1600, 1600, 64] (bf16) this script draws q, k, v and dO from a fixed
seed on the card, runs the forward once through ``FusedAttentionFn``
(``fused_attention``) and keeps its graph, then profiles ``REPEATS``
backward passes of that graph (``torch.autograd.grad`` with the graph
retained: delta = rowsum(dO * out), dq and dk/dv, as a train step runs
them) under ``torch.profiler`` and prints the device ms of one backward by
kernel, grouped as delta (every kernel that is not an ``attn_`` kernel:
the float32 casts, the product and the row sum), dq and dk/dv, with
delta's share of the three. Each checkout runs in a process of its own
(a profiler, once attached, slows every later launch of its process):

    python3 probes/k3_backward_profile.py [checkout ...]

(no checkout: this one alone). It prints one JSON line a checkout and
shape, then the card's name and power limit. It exits 1 if a checkout
failed.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((64, 1600, 1600, 32), (48, 1600, 1600, 64))
REPEATS = 20
SEED = 900


def run_one(root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    from boosted_detr_torch.ops import attention as A

    assert os.path.abspath(A.__file__).startswith(os.path.abspath(root))
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for i, (bh, tq, tk, d) in enumerate(SHAPES):
        gen = torch.Generator(device="cuda").manual_seed(SEED + i)
        q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda")
                      .bfloat16() for t in (tq, tk, tk, tq))
        leaves = tuple(t.requires_grad_() for t in (q, k, v))
        kept = A.fused_attention(*leaves)

        def backward():
            torch.autograd.grad(kept, leaves, g, retain_graph=True)

        for _ in range(3):  # built, loaded and warm
            backward()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            for _ in range(REPEATS):
                backward()
            torch.cuda.synchronize()
        by_kernel = collections.Counter()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                by_kernel[e.key] += e.self_device_time_total / 1e3 / REPEATS
        groups = collections.Counter()
        for name, ms in by_kernel.items():
            groups["dq" if "attn_dq" in name else
                   "dkdv" if "attn_dkdv" in name else "delta"] += ms
        total = sum(groups.values())
        row = {"root": root, "shape": [bh, tq, tk, d],
               "device_ms": dict(groups), "total_ms": total,
               "delta_share": groups["delta"] / total if total else None,
               "kernels": {n[:90]: ms for n, ms in by_kernel.most_common()}}
        print(json.dumps(row), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        run_one(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("k3_backward_profile: no CUDA card", file=sys.stderr)
        return 1
    failed = False
    for root in sys.argv[1:] or [HERE]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            capture_output=True, text=True, check=False, timeout=600)
        print(proc.stdout.rstrip(), flush=True)
        if proc.returncode != 0:
            print(f"{root}: failed\n{proc.stderr[-3000:]}", flush=True)
            failed = True
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
