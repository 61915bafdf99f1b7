"""The ``flagship_900q`` train step's losses, bit for bit, from a checkout.

``chip_smoke.py``'s ``flagship_900q`` path trains the 640 flagship at 900
queries and ``max_objects=120``, which takes K2's columns route at
[8, 120, 900] once a step. A redesign of that route that keeps its mask
keeps the step's losses to the bit. This script builds that path as
``chip_smoke.py``'s ``phase_training`` does (the same model, seeds, batch
and step) from the checkout at ROOT, runs its warm-up step and one step,
and prints each loss as a float's hex digits, with K2's launches and the
card's name and power limit. Run it once for each checkout, each in a
process of its own (a checkout imports its own port), on one card:

    python3 probes/lap_loss_bits.py archive/parent
    python3 probes/lap_loss_bits.py .

and compare the lines.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path


def main(argv) -> int:
    root = Path(argv[0] if argv else ".").resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("lap_loss_bits: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import boosted_detr_torch as bt
    import chip_smoke as cs
    from boosted_detr_torch.ops import build
    from boosted_detr_torch.ops import lap as L

    if not str(Path(cs.__file__).resolve()).startswith(str(root)):
        raise RuntimeError(f"imported {cs.__file__}, not {root}'s")
    build.build_all()
    name = "flagship_900q"
    path = cs.PATHS[name]
    cfg = cs._path_config(name, cs._codec())
    tcfg = bt.TrainConfig(batch_size=cs.BATCH, **path.get("train", {}))
    model = cs._build(path, cfg, seed=0)
    cs._randomize_skip_gains(model, seed=6)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
    step = cs._step_builder(path, model, cfg, tcfg)
    batch = cs._path_batch(path, model, cfg, cs.BATCH, model.device)
    before = L.hungarian_lap.launches
    losses = []
    for _ in range(2):  # the warm-up step and one step, as the smoke run
        state, aux = step(state, batch)
        losses.append({k: float(v.item()).hex() for k, v in
                       sorted(aux.items())})
    torch.cuda.synchronize()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    print(json.dumps({"checkout": str(root), "card": card,
                      "k2_launches": L.hungarian_lap.launches - before,
                      "losses": losses}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
