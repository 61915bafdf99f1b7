"""Roofline of the flagship train step on one H100: each component's
operations and bytes against the card's peaks.

Usage (no card needed: nothing runs on one):

    python -m boosted_detr_torch.benchmarks.roofline [--batch 8]
        [--norm batchnorm] [--full] [--measured NAME=MS ...]

The counterpart of benchmarks/roofline.py for the port. For each bucket of
the 640 flagship (ResNet ``patchify8``, batch 8, bf16) — stem, 80px, 40px,
20px, neck + transformer + heads (``det``), matcher, loss, optimizer — it
counts the work of a train-like forward and backward (gradients of the
parameters and, past the stem, of the input) on the ``meta`` device,
through the port's plain route, and prints

    attainable_ms = max(flops / peak, bytes / 3.35 TB/s)

- operations by operand type, with ``torch.utils.flop_counter``'s counts of
  every matmul, convolution and attention call (``WorkCounter``): bf16 at
  989 TFLOP/s, float32 at 67 TFLOP/s (TF32 off, as the port runs), from
  NVIDIA's H100 SXM data sheet, at its 700 W power limit;
- bytes by the rule of a bound: each input of the bucket read once and
  each output written once (activations in and out, the gradient coming
  in and going out, parameters, their gradients and BatchNorm's running
  statistics). ``op_mb`` beside it counts each operator's inputs and
  outputs as an unfused eager program moves them, the bytes fusion could
  save;
- the matcher from the shapes of [B, O, P] (its work depends on the data):
  the cost read once, the mask written once, and one comparison for each
  cost, its least work; the optimizer (SGD with Nesterov momentum and the
  per-tensor clip) from the parameter count: each parameter, gradient and
  momentum read once, parameter and momentum written once, nine float32
  operations each.

``--full`` counts the whole step (model, loss, matcher, optimizer) as one
function. ``--measured NAME=MS`` prints a measured time (for example from
profile_step.py's ``by_resolution`` or ``by_component`` on the card) and
the attainable share of it beside a bucket; without one the column reads
"not measured". The card's power limit is printed where a card is
present: the peaks assume 700 W.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils import flop_counter
from torch.utils._python_dispatch import TorchDispatchMode

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
                  torch.float32: 67e12}
OPTIMIZER_OPS_PER_PARAM = 9


class WorkCounter(TorchDispatchMode):
    """Counts, over the operators dispatched inside it, the operations of
    every call ``torch.utils.flop_counter`` knows (by the dtype of its
    first operand) and the bytes of each operator's tensor inputs and
    outputs (views move none)."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[torch.dtype, int] = collections.Counter()
        self.op_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        count = flop_counter.flop_registry.get(func._overloadpacket)
        tensors = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(a, torch.Tensor)]
        if count is not None:
            self.flops[tensors[0].dtype] += count(*args, **kwargs,
                                                  out_val=out)
        if not func.is_view:
            outs = [o for o in torch.utils._pytree.tree_leaves(out)
                    if isinstance(o, torch.Tensor)]
            self.op_bytes += sum(_nbytes(t) for t in tensors + outs)
        return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _module_bytes(module: torch.nn.Module) -> int:
    """Parameters read and their gradients written; buffers (BatchNorm's
    running statistics) read and written."""
    params = sum(_nbytes(p) for p in module.parameters())
    buffers = sum(_nbytes(b) for b in module.buffers())
    return 2 * params + 2 * buffers


def train_count(module: torch.nn.Module, fn: Callable, x: torch.Tensor,
                input_grad: bool = True) -> Dict[str, object]:
    """The work of ``fn(x)`` (a forward through ``module``) and its backward
    from a sum-of-squares head, on meta tensors: ``flops`` by dtype,
    ``bytes`` by the rule (``x``, the output, the gradient in and, with
    ``input_grad``, out; the module's parameters, gradients and buffers)
    and ``op_bytes``."""
    x = x.detach().requires_grad_(input_grad)
    with WorkCounter() as c:
        out = fn(x)
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        loss = sum((o.float() ** 2).sum() for o in outs)
        loss.backward()
    out_bytes = sum(_nbytes(o) for o in outs)
    n_bytes = (_nbytes(x) * (2 if input_grad else 1) + 2 * out_bytes
               + _module_bytes(module))
    return {"flops": dict(c.flops), "bytes": n_bytes,
            "op_bytes": c.op_bytes}


def _meta(module: torch.nn.Module) -> torch.nn.Module:
    return module.to("meta").train()


def backbone_rows(batch: int, norm: str, side: int = 640
                  ) -> Dict[str, Dict[str, object]]:
    """The stem and the three stages of the ``patchify8`` ResNet (the
    stem's plain conv: K1 computes the same conv)."""
    from boosted_detr_torch.models.backbone import ResNetBackbone

    net = _meta(ResNetBackbone(1.0, norm, torch.bfloat16, "patchify8"))
    x = torch.empty(batch, side, side, 3, device="meta")
    rows = {"stem": train_count(net.stem, net.stem, x, input_grad=False)}
    x = torch.empty(batch, side // 8, side // 8, 128, device="meta",
                    dtype=torch.bfloat16)
    for stage, label in ((1, "80px"), (2, "40px"), (3, "20px")):
        blocks = torch.nn.ModuleList(getattr(net, n) for n in net.block_names
                                     if n.startswith(f"stage{stage}_"))

        def run(x, blocks=blocks):
            for b in blocks:
                x = b(x)
            return x

        rows[label] = train_count(blocks, run, x)
        x = torch.empty(run(x).shape, device="meta", dtype=torch.bfloat16)
    return rows


class _Features(torch.nn.Module):
    """A backbone stand-in that hands the neck the given features."""

    needs_generator = False

    def forward(self, x, generator=None):
        return x


def flagship_config(norm: str = "batchnorm"):
    from boosted_detr_torch.config import ModelConfig

    return ModelConfig(image_size=(640, 640), backbone="resnet",
                       compute_dtype="bfloat16", max_objects=32,
                       matcher="pallas", stem="patchify8", norm=norm,
                       dropout_rate=0.0)


def det_row(model, batch: int) -> Dict[str, object]:
    """Neck, transformer and heads on the backbone's [B, 20, 20, 2048]."""
    backbone = model.backbone
    model.backbone = _Features()
    try:
        x = torch.empty(batch, 20, 20, backbone.out_channels, device="meta",
                        dtype=torch.bfloat16)
        return train_count(model, lambda x: model(x), x)
    finally:
        model.backbone = backbone


def _loss_inputs(cfg, batch: int):
    b, o, p = batch, cfg.max_objects, cfg.num_object_preds
    targets = (torch.empty(b, o, cfg.num_categories, device="meta"),
               torch.empty(b, o, cfg.num_attributes, device="meta"),
               torch.empty(b, o, 4, device="meta"),
               torch.empty(b, dtype=torch.int32, device="meta"))
    preds = (torch.empty(b, p, cfg.num_categories, device="meta"),
             torch.empty(b, p, cfg.num_attributes, device="meta"),
             torch.empty(b, p, 4, device="meta"))
    return targets, preds


@contextlib.contextmanager
def _stand_in_matcher():
    """``solve_matching`` replaced by an empty mask of the cost's shape: on
    meta tensors nothing is solved; the matcher is counted apart."""
    from boosted_detr_torch.ops import matching

    solve = matching.solve_matching
    matching.solve_matching = (
        lambda cost, n, method="hungarian": torch.zeros_like(cost))
    try:
        yield
    finally:
        matching.solve_matching = solve


def loss_row(cfg, batch: int) -> Dict[str, object]:
    """The matched loss (costs, reductions) forward and backward to the
    predictions, float32."""
    from boosted_detr_torch.ops import matching

    targets, preds = _loss_inputs(cfg, batch)
    preds = [p.requires_grad_() for p in preds]
    with _stand_in_matcher(), WorkCounter() as c:
        losses, _ = matching.matching_loss(*targets, *preds,
                                           matcher=cfg.matcher)
        losses["total"].sum().backward()
    n_bytes = (sum(_nbytes(t) for t in targets)
               + 2 * sum(_nbytes(p) for p in preds))
    return {"flops": dict(c.flops), "bytes": n_bytes,
            "op_bytes": c.op_bytes}


def matcher_row(b: int, o: int, p: int) -> Dict[str, object]:
    """K2's least work at [B, O, P]: the cost read, the mask written, one
    float32 comparison a cost."""
    n_bytes = 2 * b * o * p * 4 + b * 4
    return {"flops": {torch.float32: b * o * p}, "bytes": n_bytes,
            "op_bytes": n_bytes}


def optimizer_row(n_params: int) -> Dict[str, object]:
    """SGD with Nesterov momentum and the per-tensor clip over float32
    parameters: parameter, gradient and momentum read; parameter and
    momentum written."""
    return {"flops": {torch.float32: OPTIMIZER_OPS_PER_PARAM * n_params},
            "bytes": 20 * n_params, "op_bytes": 20 * n_params}


def full_row(model, cfg, batch: int) -> Dict[str, object]:
    """The whole train step as one function: the forward from the image,
    the matched loss, its backward, the matcher and the optimizer."""
    from boosted_detr_torch.ops import matching

    side = cfg.image_size[0]
    image = torch.empty(batch, side, side, 3, device="meta")
    targets, _ = _loss_inputs(cfg, batch)
    with _stand_in_matcher(), WorkCounter() as c:
        preds = model(image)
        losses, _ = matching.matching_loss(
            *targets, preds["category"], preds["attribute"], preds["boxes"],
            matcher=cfg.matcher)
        losses["total"].sum().backward()
    n_params = sum(p.numel() for p in model.parameters())
    flops = collections.Counter(c.flops)
    matcher = matcher_row(batch, cfg.max_objects, cfg.num_object_preds)
    opt = optimizer_row(n_params)
    for row in (matcher, opt):
        flops.update(row["flops"])
    n_bytes = (_nbytes(image) + sum(_nbytes(t) for t in targets)
               + 2 * sum(_nbytes(b) for b in model.buffers())
               + opt["bytes"])
    return {"flops": dict(flops), "bytes": n_bytes,
            "op_bytes": c.op_bytes + matcher["op_bytes"] + opt["op_bytes"]}


def bound(row: Mapping[str, object]) -> Tuple[float, str]:
    """(attainable ms, "operations" or "bytes")."""
    flop_s = sum(n / PEAK_OPS_PER_S[dt] for dt, n in row["flops"].items())
    byte_s = row["bytes"] / HBM_BYTES_PER_S
    return (max(flop_s, byte_s) * 1e3,
            "operations" if flop_s >= byte_s else "bytes")


def rows_for(batch: int, norm: str, full: bool = False
             ) -> Dict[str, Dict[str, object]]:
    from boosted_detr_torch.models.detr import DETR

    cfg = flagship_config(norm)
    rows = backbone_rows(batch, norm, cfg.image_size[0])
    model = _meta(DETR(cfg.replace(use_pallas_stem=False), device="cpu"))
    rows["det"] = det_row(model, batch)
    rows["matcher"] = matcher_row(batch, cfg.max_objects,
                                  cfg.num_object_preds)
    rows["loss"] = loss_row(cfg, batch)
    rows["optimizer"] = optimizer_row(sum(p.numel()
                                          for p in model.parameters()))
    if full:
        for p in model.parameters():
            p.grad = None
        rows["full step"] = full_row(model, cfg, batch)
    return rows


def _power_limit() -> Optional[float]:
    if not torch.cuda.is_available():
        return None
    from boosted_detr_torch.benchmarks import run_benchmarks as rb

    return rb.card_info(torch.device("cuda"))["power_limit_w"]


def report(rows: Mapping[str, Mapping[str, object]],
           measured: Mapping[str, float], power_limit_w: Optional[float]
           ) -> Dict[str, object]:
    limit = (f"the card's power limit {power_limit_w} W"
             if power_limit_w is not None else "no card here")
    print(f"peaks (NVIDIA H100 SXM data sheet, at 700 W; {limit}): bf16 "
          f"989 TFLOP/s, float32 67 TFLOP/s, HBM 3.35 TB/s")
    print(f"{'bucket':10s} {'GFLOP bf16':>10s} {'GFLOP f32':>10s} "
          f"{'MB':>9s} {'op MB':>9s} {'bound by':>10s} {'attain ms':>10s} "
          f"{'measured ms':>12s} {'share':>7s}")
    out = []
    for name, row in rows.items():
        attain, by = bound(row)
        meas = measured.get(name)
        share = attain / meas if meas else None
        gf = {dt: row["flops"].get(dt, 0) / 1e9
              for dt in (torch.bfloat16, torch.float32)}
        print(f"{name:10s} {gf[torch.bfloat16]:10.2f} "
              f"{gf[torch.float32]:10.2f} {row['bytes'] / 1e6:9.1f} "
              f"{row['op_bytes'] / 1e6:9.1f} {by:>10s} {attain:10.4f} "
              + (f"{meas:12.3f} {100 * share:6.1f}%" if meas else
                 f"{'not measured':>12s} {'-':>7s}"))
        out.append({"bucket": name,
                    "gflop": {str(dt).replace("torch.", ""): n / 1e9
                              for dt, n in row["flops"].items()},
                    "mb": row["bytes"] / 1e6, "op_mb": row["op_bytes"] / 1e6,
                    "bound_by": by, "attainable_ms": attain,
                    "measured_ms": meas, "share": share})
    line = {"rows": out, "power_limit_w": power_limit_w}
    print("ROOFLINE " + json.dumps(line))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m boosted_detr_torch.benchmarks.roofline")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--norm", default="batchnorm",
                    help="batchnorm | skipinit backbone pieces")
    ap.add_argument("--full", action="store_true",
                    help="also count the whole train step as one function")
    ap.add_argument("--measured", action="append", default=[],
                    metavar="NAME=MS", help="a measured ms for a bucket")
    args = ap.parse_args(argv)
    measured = {}
    for kv in args.measured:
        name, _, ms = kv.partition("=")
        measured[name] = float(ms)
    report(rows_for(args.batch, args.norm, args.full), measured,
           _power_limit())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
