"""How far float32 rounding alone moves the dry run's gradients.

``boosted_detr_torch/parallel/dryrun.py`` holds each family's step across
processes to its one-process step. Its ranks compute the same step in
another order of float32 sums (each rank's convolutions and products at
its own batch size, the row-split layers' partial products), and at the
tiny config, with live BatchNorm over 1-2 rows a rank, the gradients
amplify such rounding. This script measures that amplification in one
process, with no process group: each family's one-process step on the
dry run's global batch, and again with every image value moved by one
float32 ulp; it prints, per family, both losses and the largest change of
a leaf's gradients relative to that leaf's largest value, the quantity
``dryrun.GRAD_TOL`` bounds.

Run on the CPU from the root of a checkout:

    python3 probes/parallel_noise.py [n]

``n`` (4 by default) is the dry run's process count, which sets the
global batch.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from boosted_detr_torch.parallel import dryrun  # noqa: E402


def main() -> int:
    torch.set_num_threads(2)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    shape = dryrun.mesh_shape(n)
    batch = dryrun.global_batch(dryrun.tiny_config(),
                                max(n, shape["data"]))
    moved = dict(batch, image=np.nextafter(
        batch["image"], np.float32(2.0)).astype(np.float32))
    for name in dryrun.FAMILIES:
        a = dryrun.run_family(name, shape, batch)
        b = dryrun.run_family(name, shape, moved)
        worst = max(float(np.abs(a["grads"][k] - b["grads"][k]).max())
                    / max(float(np.abs(a["grads"][k]).max()), 1.0)
                    for k in a["grads"])
        print(json.dumps({"family": name, "global_batch": len(batch["image"]),
                          "loss": a["loss"], "loss_one_ulp": b["loss"],
                          "grad_change_of_leaf_max": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
