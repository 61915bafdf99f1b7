"""What the multi-process tests run on each rank, and in one process for the
reference: no test here, and no JAX, so that a rank (a ``python -c``
process that imports this module, with one thread, meeting the others at
a ``file://`` store under the test's ``tmp_path``) never imports JAX.

``run_ranks(fn, payload, n, tmp)`` writes ``payload`` to ``tmp``, starts
``n`` ranks that each call ``fn(payload, mesh)`` on a mesh of
``payload["mesh"]`` (every rank on 'data' by default) and save what it
returns, and gives back the ranks' results in rank order. A rank that
fails, or a run past ``timeout`` seconds, fails the test.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

TESTS = Path(__file__).resolve().parent

WORKER = """
import sys
sys.path.insert(0, {tests!r})
import numpy as np, torch
torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import torch_parallel_cases as cases
from boosted_detr_torch.parallel import mesh as mesh_lib
from boosted_detr_torch.parallel import multiprocess
fn, rank, n, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
payload = np.load(tmp + "/payload.npy", allow_pickle=True).item()
device = payload.get("device", "cpu")
multiprocess.initialize(payload["init"], n, rank,
                        backend=payload.get("backend", "gloo"), device=device)
mesh = mesh_lib.make_mesh(payload.get("mesh"), device=device)
np.save(tmp + f"/result_{{rank}}.npy", getattr(cases, fn)(payload, mesh),
        allow_pickle=True)
""".format(tests=str(TESTS))


def run_ranks(fn: str, payload: Dict, n: int, tmp, timeout: float = 120,
              backend: str = "gloo") -> List[Dict]:
    from boosted_detr_torch.parallel.dryrun import spawn

    tmp = Path(tmp)
    payload = dict(payload, init=(tmp / "store").as_uri(), backend=backend)
    np.save(tmp / "payload.npy", payload, allow_pickle=True)
    spawn([["-c", WORKER, fn, str(r), str(n), str(tmp)] for r in range(n)],
          timeout=timeout)
    return [np.load(tmp / f"result_{r}.npy", allow_pickle=True).item()
            for r in range(n)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def mesh_case(payload, mesh) -> Dict:
    """This rank's coordinates on each of ``payload["shapes"]``, or the
    error ``make_mesh`` raised."""
    from boosted_detr_torch.parallel import mesh as mesh_lib

    out = {}
    for shape in payload["shapes"]:
        try:
            m = mesh_lib.make_mesh(shape, device="cpu")
            out[str(shape)] = (dict(m.shape), dict(m.coords))
        except ValueError as exc:
            out[str(shape)] = str(exc)
    return out


def context_case(payload, mesh) -> Dict:
    """Context-parallel attention of ``payload``'s q and this rank's shard
    of k and v (over 'model'), in both impls: the output, and the
    gradients of sum(out^2) for q (whole) and this rank's k and v."""
    from boosted_detr_torch.ops import attention
    from boosted_detr_torch.parallel import mesh as mesh_lib
    from boosted_detr_torch.parallel.context_parallel import \
        context_parallel_attention

    device = mesh.device
    dtype = getattr(torch, payload.get("dtype", "float32"))
    index, size = mesh.coords[mesh_lib.MODEL_AXIS], mesh.shape[
        mesh_lib.MODEL_AXIS]
    per = payload["k"].shape[1] // size
    out = {}
    for impl in payload["impls"]:
        q = torch.from_numpy(payload["q"]).to(device, dtype).requires_grad_()
        k, v = (torch.from_numpy(payload[x][:, index * per:(index + 1) * per]
                                 ).to(device, dtype).requires_grad_()
                for x in ("k", "v"))
        o = context_parallel_attention(q, k, v, mesh, axis="model",
                                       impl=impl)
        (o.float() ** 2).sum().backward()
        out[impl] = {"out": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
                     "dv": _np(v.grad)}
    out["launches"] = {name: getattr(attention, name).launches
                       for name in ("attention_fwd", "attention_dq",
                                    "attention_dkdv")}
    return out


def build_model(payload):
    """The model of a train case: ``payload["model"]`` ("detr",
    "boosted" or "panoptic") over ``payload["cfg"]`` on the payload's
    device, loaded from ``payload["variables"]`` (a Flax tree of numpy
    arrays) or drawn from ``payload["seed"]``."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.models.panoptic import DETRPanoptic

    cfg = bt.ModelConfig(**payload["cfg"])
    device = payload.get("device", "cpu")
    kind = payload["model"]
    seed = payload.get("seed", 0)
    if kind == "panoptic":
        model = DETRPanoptic(cfg, mask_size=payload["mask_size"],
                             device=device, seed=seed)
    else:
        model = {"detr": bt.DETR, "boosted": bt.BoostedDETR}[kind](
            cfg, device=device, seed=seed)
    if "variables" in payload:
        bt.load_flax_variables(model, payload["variables"])
    return cfg, model


def train_case(payload, mesh) -> Dict:
    """One train step of ``payload``'s model (``build_model``) and
    ``TrainConfig(**payload["train"])`` on ``payload["batch"]`` (the
    global batch; under a mesh of several ranks, this rank's rows of it):
    the step's metrics, the gradients as the optimizer receives them (the
    all-reduced ones, before the clip), and the parameters and running
    statistics after the update, by the port's names."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.models import panoptic
    from boosted_detr_torch.parallel import mesh as mesh_lib

    cfg, model = build_model(payload)
    tcfg = bt.TrainConfig(**payload["train"])
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.parameters(), d_model=cfg.decoder_dim))
    if payload["model"] == "panoptic":
        step = panoptic.make_panoptic_train_step(model, tcfg)
    else:
        step = bt.make_train_step(model, cfg, tcfg)
    batch = payload["batch"]
    if mesh is not None and mesh.world > 1:
        batch = mesh_lib.shard_batch(batch, mesh)
    else:
        batch = {k: torch.from_numpy(v).to(payload.get("device", "cpu"))
                 for k, v in batch.items()}
    grads = {}
    optimizer = state.optimizer
    named = dict(model.named_parameters())

    def capture():
        grads.update({k: _np(p.grad) for k, p in named.items()
                      if p.grad is not None})
        type(optimizer).step(optimizer)

    optimizer.step = capture
    state, aux = step(state, batch)
    return {"aux": {k: float(v) for k, v in aux.items()}, "grads": grads,
            "state": {k: _np(v) for k, v in model.state_dict().items()}}


def same_on_every_rank(results: List[Dict]) -> Dict:
    """The ranks' train results, which must be equal bit for bit."""
    first = results[0]
    for r, other in enumerate(results[1:], 1):
        assert other["aux"] == first["aux"], (r, other["aux"], first["aux"])
        for key in ("grads", "state"):
            for name, value in first[key].items():
                assert np.array_equal(other[key][name], value), (r, key,
                                                                 name)
    return first


def train_cases(payload, mesh) -> Dict:
    """``train_case`` of each entry of ``payload["cases"]``."""
    return {name: train_case(case, mesh)
            for name, case in payload["cases"].items()}


def split_mismatch_case(payload, mesh) -> Dict:
    """A DETR split by ``shard_module`` over ``mesh`` ('model' 2), then
    trained under each mesh shape of ``payload["shapes"]``: the
    ``ValueError`` its first step raises, or "ran"."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.parallel import sharding

    cfg = bt.ModelConfig(**payload["cfg"])
    model = bt.DETR(cfg, device="cpu", seed=0)
    sharding.shard_module(model, mesh)
    batch = {k: torch.from_numpy(v) for k, v in payload["batch"].items()}
    out = {}
    for shape in payload["shapes"]:
        tcfg = bt.TrainConfig(batch_size=len(batch["image"]),
                              mesh_shape=shape)
        state = bt.TrainState.create(model, bt.make_optimizer(
            tcfg, model.parameters(), d_model=cfg.decoder_dim))
        try:
            bt.make_train_step(model, cfg, tcfg)(state, batch)
            out[str(shape)] = "ran"
        except ValueError as exc:
            out[str(shape)] = str(exc)
    return out
