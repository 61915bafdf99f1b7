"""What one rounding of the stem moves in ``chip_smoke.py``'s one-step loss
check, on one card.

``chip_smoke.py`` trains each path for its warm-up, timed and profiled
steps, then takes one more step from that state with the kernels and with
the plain versions of every kernel, and holds the two losses together.
This script reaches the same state by the same steps and reads, there:

- the loss with the kernels, with the plain versions, and with each
  kernel of the step alone on its plain version (which kernel moves it);
- how many object rows the matcher assigns to another prediction in the
  plain step than in the kernel step (a discrete change of the loss);
- the stem's forward (K1-fwd) against its plain version on that step's
  own input: how many outputs differ, how many of those lie nearer zero
  than the plain version's, and by how much;
- the loss of the plain step with ``flips`` outputs of the plain stem
  moved by one bf16 ulp at random places (``--draws`` draws), where
  ``flips`` is the count K1-fwd differs in: the spread that one rounding
  of the same size gives a step of the plain versions alone.

Run on a card from the root of a checkout:

    python3 probes/loss_check_noise.py [--paths flagship,...] [--draws 8]

It prints the card's name and power limit and one JSON line a path.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _rel(a, b):
    return abs(a - b) / abs(b)


def _one_ulp(out, count, seed):
    """``out`` (bf16) with ``count`` values at random places moved one ulp
    up or down in magnitude."""
    gen = torch.Generator(device=out.device).manual_seed(seed)
    flat = out.reshape(-1).clone()
    where = torch.randperm(flat.numel(), generator=gen,
                           device=out.device)[:count]
    step = torch.randint(0, 2, (count,), generator=gen,
                         device=out.device).to(torch.int16) * 2 - 1
    bits = flat.view(torch.int16)
    bits[where] += step
    return flat.reshape(out.shape)


def path_readings(name, draws):
    import boosted_detr_torch as bt
    from boosted_detr_torch.ops import matching as M
    from boosted_detr_torch.ops import patchify as P

    warmup, steps = ((cs.TRAIN_WARMUP, cs.TRAIN_STEPS) if name == "flagship"
                     else (cs.HR_TRAIN_WARMUP, cs.HR_TRAIN_STEPS))
    path = cs.PATHS[name]
    cfg = cs._path_config(name, cs._codec())
    tcfg = bt.TrainConfig(batch_size=cs.BATCH, **path.get("train", {}))
    # chip_smoke's model, optimizer, step builder and batch for the path
    model = cs._build(path, cfg, seed=0)
    cs._randomize_skip_gains(model, seed=6)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
    step = cs._step_builder(path, model, cfg, tcfg)
    batch = cs._path_batch(path, model, cfg, cs.BATCH, model.device)
    # chip_smoke's warm-up, timed and profiled steps
    for _ in range(warmup + steps + 1):
        state, _ = step(state, batch)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    at = state.step

    masks = {}  # the assignment of the last step of each kind

    def loss(plain=(), stem=None):
        nonlocal state
        model.load_state_dict(snapshot)
        state.step = at
        saved = P.patchify_conv_reference
        solve = M.solve_matching

        def recording_solver(cost, num_objects, method="hungarian"):
            mask = solve(cost, num_objects, method)
            masks[plain, stem is None] = mask.clone()
            return mask

        if stem is not None:
            P.patchify_conv_reference = stem
        M.solve_matching = recording_solver
        try:
            with cs._plain_versions(plain):
                state, aux = step(state, batch)
        finally:
            P.patchify_conv_reference = saved
            M.solve_matching = solve
        return aux["loss"].item()

    # the stem's input on the kernel step
    seen = {}
    kernel = P.patchify_conv

    def recording(x, w, **kw):
        seen.update(x=x.detach().clone(), w=w.detach().clone(), kw=kw)
        return kernel(x, w, **kw)

    # the wrapper counts its launches on the module's name for it
    recording.launches = kernel.launches
    P.patchify_conv = recording
    try:
        kernel_loss = loss()
    finally:
        P.patchify_conv = kernel
    plain_loss = loss(tuple(cs.KERNELS))
    row = {"path": name, "step": at, "kernel_loss": kernel_loss,
           "plain_loss": plain_loss,
           "rel": _rel(kernel_loss, plain_loss)}
    in_step = [k for k, n in cs.PATHS[name]["step"].items() if n]
    row["rel_with_only_this_plain"] = {
        k: _rel(loss((k,)), plain_loss) for k in in_step}
    if ((), True) in masks:
        # the matched prediction of each object row, kernel step against
        # the plain one: a row that moved is a discrete change of the loss
        moved = (masks[(), True] != masks[tuple(cs.KERNELS), True]).any(-1)
        row["assignment_rows_moved"] = int(moved.sum())
        row["assignment_rows"] = int(masks[(), True].amax(-1).sum())

    got = kernel(seen["x"], seen["w"], **seen["kw"])
    want = P.patchify_conv_reference(seen["x"], seen["w"], **seen["kw"])
    diff = (got.float() - want.float()).abs()
    flips = int((diff > 0).sum())
    # a rounding that is not biased moves as many outputs up as down
    smaller = got.float().abs() < want.float().abs()
    row.update(stem_outputs=want.numel(), stem_flips=flips,
               stem_flips_toward_zero=int((smaller & (diff > 0)).sum()),
               stem_max_abs_diff=diff.max().item())
    plain_stem = P.patchify_conv_reference

    spread = []
    for seed in range(draws):
        def perturbed(x, w, *, _seed=seed, **kw):
            return _one_ulp(plain_stem(x, w, **kw), flips, _seed)
        spread.append(_rel(loss(tuple(cs.KERNELS), perturbed), plain_loss))
    row["rel_plain_with_one_ulp_flips"] = spread
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("loss_check_noise: no CUDA card", file=sys.stderr)
        return 1
    parser = argparse.ArgumentParser()
    parser.add_argument("--paths", default=",".join(cs.PATHS))
    parser.add_argument("--draws", type=int, default=8)
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for name in args.paths.split(","):
        print(json.dumps(path_readings(name, args.draws)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
