"""One tensor- and data-parallel train step of each model family across
``n`` processes on the CPU, held against the one-process step.

Counterpart of ``__graft_entry__.py::dryrun_multichip``: there one process
shards a step over ``n`` virtual devices; here ``n`` processes (gloo,
one thread each, meeting at a ``file://`` store) form a mesh of
``data = n / 2`` and ``model = 2`` (all on 'data' when ``n`` is odd or
below 4), and each runs one step of DETR, BoostedDETR (intermediate
losses), DETRPanoptic (``mask_size=16``) and DETRMultiClassifier on the
tiny config, with the batch split over 'data' and the attention and FFN
split over 'model' (``sharding.shard_module``). Each step must give a
finite loss and step 1; rank 0 prints the lines JAX prints. Then this
process runs each family's step unsharded on the global batch and holds
the ranks to it: the loss, every gradient as the optimizer receives it
(the split ones put back together) and every parameter after the update,
and every rank of one 'model' coordinate holds the same bits.

    python -m boosted_detr_torch.parallel.dryrun [n]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
FAMILIES = ("DETR", "Boosted", "Panoptic", "Pretrainer")
# float32 sums in other orders (each rank's convolutions and products at
# its own batch size, the row-split layers' partial products, the
# gradients' all-reduce): a few ulps of the loss. Live BatchNorm over 1-2
# rows a rank makes the gradients chaotic at this size: a one-ulp change of
# the images moves a leaf's gradients by up to 1.2e-3 of its largest value
# (probes/parallel_noise.py), so they are held at a few times that.
LOSS_RTOL = 1e-5
GRAD_TOL = 5e-3
TIMEOUT_S = 300


def tiny_config():
    """The dry run's config (``__graft_entry__.py:18-24``)."""
    from boosted_detr_torch.config import ModelConfig

    return ModelConfig(
        num_object_preds=16, image_size=(64, 64), num_encoder_blocks=2,
        num_encoder_heads=2, encoder_dim=32, num_decoder_blocks=2,
        num_decoder_heads=2, decoder_dim=32, num_categories=12,
        num_attributes=8, backbone="tiny", backbone_width=0.25,
        compute_dtype="float32", max_objects=4, dropout_rate=0.0)


def mesh_shape(n: int) -> Dict[str, int]:
    model = 2 if n % 2 == 0 and n >= 4 else 1
    return {"data": n // model, "model": model}


def global_batch(cfg, b: int) -> Dict[str, np.ndarray]:
    """The global batch, drawn as ``dryrun_multichip`` draws it."""
    h, w = cfg.image_size
    o = cfg.max_objects
    rng = np.random.default_rng(0)
    batch = {
        "image": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "category_ids": rng.integers(2, cfg.num_categories,
                                     (b, o)).astype(np.int32),
        "attribute_ids": rng.integers(0, cfg.num_attributes,
                                      (b, o, 2)).astype(np.int32),
        "bbox": rng.uniform(0.1, 0.4, (b, o, 4)).astype(np.float32),
        "num_objects": np.full((b,), o, np.int32),
    }
    batch["masks"] = (rng.uniform(0, 1, (b, o, 16, 16)) > 0.5).astype(
        np.float32)
    return batch


def run_family(name: str, shape: Dict[str, int], batch, mesh=None) -> Dict:
    """One step of family ``name`` under ``mesh`` (None: one process, the
    whole batch): its loss, step, gradients as the optimizer receives
    them and parameters after the update (this rank's slices), and each
    parameter's split dim (-1: whole)."""
    from boosted_detr_torch.config import TrainConfig
    from boosted_detr_torch.models import panoptic, pretrainer
    from boosted_detr_torch.models.boosted import BoostedDETR
    from boosted_detr_torch.models.detr import DETR
    from boosted_detr_torch.parallel import mesh as mesh_lib
    from boosted_detr_torch.parallel import sharding
    from boosted_detr_torch.train import steps

    cfg = tiny_config()
    b = len(batch["image"])
    seed = FAMILIES.index(name)
    tcfg = TrainConfig(batch_size=b, clipnorm=0.1,
                       mesh_shape=shape if mesh is not None else None)
    if name == "DETR":
        model = DETR(cfg, device="cpu", seed=seed)
    elif name == "Boosted":
        model = BoostedDETR(cfg, device="cpu", seed=seed)
        tcfg = tcfg.replace(use_intermediate_losses=True)
    elif name == "Panoptic":
        model = panoptic.DETRPanoptic(cfg, mask_size=16, device="cpu",
                                      seed=seed)
    else:
        model = pretrainer.DETRMultiClassifier(
            cfg, num_classifier_classes=cfg.num_categories, hidden_dim=32,
            device="cpu", seed=seed)
    if mesh is not None:
        sharding.shard_module(model, mesh)
    state = steps.TrainState.create(model, steps.make_optimizer(
        tcfg, model.parameters(), d_model=cfg.decoder_dim))
    if name == "Panoptic":
        step = panoptic.make_panoptic_train_step(model, tcfg)
    elif name == "Pretrainer":
        step = pretrainer.make_pretrain_step(
            model, mesh=mesh if mesh is not None
            else mesh_lib.make_mesh(device="cpu"))
    else:
        step = steps.make_train_step(model, cfg, tcfg)
    local = (mesh_lib.shard_batch(batch, mesh) if mesh is not None
             else {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {}
    optimizer = state.optimizer
    named = dict(model.named_parameters())

    def capture():
        grads.update({k: p.grad.numpy().copy() for k, p in named.items()
                      if p.grad is not None})
        type(optimizer).step(optimizer)

    optimizer.step = capture
    state, aux = step(state, local)
    loss = float(aux["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite {name} loss {loss}")
    if state.step != 1:
        raise AssertionError(f"{name} took {state.step} steps, not 1")
    return {"loss": loss, "grads": grads,
            "params": {k: p.detach().numpy().copy()
                       for k, p in named.items()},
            "split": {k: getattr(p, "tp_split", (-1,))[0]
                      for k, p in named.items()}}


def worker(rank: int, n: int, init: str, out_dir: str) -> None:
    """One rank: every family's step, each result saved to ``out_dir``."""
    torch.set_num_threads(1)
    from boosted_detr_torch.parallel import mesh as mesh_lib
    from boosted_detr_torch.parallel import multiprocess

    multiprocess.initialize(init, n, rank, backend="gloo", device="cpu")
    shape = mesh_shape(n)
    mesh = mesh_lib.make_mesh(shape, device="cpu")
    batch = global_batch(tiny_config(), max(n, shape["data"]))
    for name in FAMILIES:
        result = run_family(name, shape, batch, mesh)
        np.save(os.path.join(out_dir, f"{name}_{rank}.npy"), result,
                allow_pickle=True)
        if rank == 0:
            print(f"dryrun_multichip({n}): {name} mesh={mesh.shape} "
                  f"loss={result['loss']:.3f} OK", flush=True)


def spawn(argvs: List[List[str]], timeout: float = TIMEOUT_S) -> List[str]:
    """Runs one Python process per argument list at once, one thread
    each, from the root of the checkout; returns their outputs. Raises if
    any exits non-zero or outlasts ``timeout`` (every process is stopped
    then)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen([sys.executable, *argv], cwd=str(ROOT),
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"processes {bad} failed:\n" + "\n".join(
            f"--- process {i}:\n{outs[i][-3000:]}" for i, _ in bad))
    return outs


def _close(got, want, what, rtol):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    if err > rtol * scale:
        raise AssertionError(f"{what}: off by {err:.3e} (allowed "
                             f"{rtol * scale:.3e})")
    return err


def _whole(parts: List[np.ndarray], dim: int) -> np.ndarray:
    return parts[0] if dim < 0 else np.concatenate(parts, axis=dim)


def compare(n: int, out_dir: str) -> Dict[str, Dict[str, float]]:
    """Each family's ranks against its one-process step on the global
    batch; returns the largest differences."""
    shape = mesh_shape(n)
    model = shape["model"]
    batch = global_batch(tiny_config(), max(n, shape["data"]))
    report = {}
    for name in FAMILIES:
        ranks = [np.load(os.path.join(out_dir, f"{name}_{r}.npy"),
                         allow_pickle=True).item() for r in range(n)]
        want = run_family(name, shape, batch)
        _close(np.float64(ranks[0]["loss"]), np.float64(want["loss"]),
               f"{name} loss", LOSS_RTOL)
        errs = {"grads": 0.0, "params": 0.0}
        for key in errs:
            for leaf, value in want[key].items():
                for r in range(model, n):  # every data replica alike
                    if not np.array_equal(ranks[r][key][leaf],
                                          ranks[r % model][key][leaf]):
                        raise AssertionError(f"{name} {key} {leaf}: rank "
                                             f"{r} differs from {r % model}")
                got = _whole([ranks[m][key][leaf] for m in range(model)],
                             ranks[0]["split"][leaf])
                errs[key] = max(errs[key], _close(
                    got, value, f"{name} {key} {leaf}", GRAD_TOL))
        report[name] = {"loss": abs(ranks[0]["loss"] - want["loss"]),
                        **errs}
        print(f"dryrun: {name} across {n} processes = one process: loss "
              f"{ranks[0]['loss']:.6f} vs {want['loss']:.6f}, gradients "
              f"within {errs['grads']:.2e}, parameters within "
              f"{errs['params']:.2e}", flush=True)
    return report


def dryrun(n: int = 4, work_dir: Optional[str] = None
           ) -> Dict[str, Dict[str, float]]:
    """The dry run on ``n`` processes (files under ``work_dir``, a fresh
    temporary directory when None); returns ``compare``'s report."""
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory(dir=work_dir) as tmp:
        init = Path(tmp, "store").as_uri()
        outs = spawn([["-m", "boosted_detr_torch.parallel.dryrun",
                       "--worker", str(r), str(n), init, tmp]
                      for r in range(n)])
        print(outs[0], end="", flush=True)
        return compare(n, tmp)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, n, init, out = sys.argv[2:6]
        worker(int(rank), int(n), init, out)
    else:
        dryrun(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
