"""Profile the flagship train step (or its inference forward) on one CUDA
card and attribute the device time.

Usage (from the root of a checkout):

    python -m boosted_detr_torch.benchmarks.profile_step [--batch 8]
        [--steps 3] [--top 25] [--infer] [--logdir DIR]

The counterpart of benchmarks/profile_step.py. It builds the model
bench_torch.py builds (``run_benchmarks.flagship_from_env``, the same
``BENCH_*`` switches; ``--batch`` in place of ``BENCH_BATCH``), runs two
warm-up steps, then ``--steps`` steps under ``torch.profiler`` with CUDA
activity and the input shapes recorded, and prints device ms per step

- by category of kernel name (``categorize``): each hand-written kernel by
  its name in ``csrc/*.cu`` (K1-fwd, K1-dW, K2, K3-fwd, K3-dq, K3-dkdv),
  cuDNN convolution, CUDA-core (float32) GEMM, tensor-core GEMM,
  BatchNorm, copies, reduction, elementwise, other;
- by activation resolution, from the input shapes of the operator that
  launched each kernel (or of the nearest enclosing one that has a spatial
  shape): the image's side and its halvings down to stride 32 (640 / 320
  / 160 / 80 / 40 / 20 for the 640 flagship), else non-spatial;
- by component: backbone, neck, det_transformer, heads, matcher,
  match_costs+loss, optimizer, other. Forward kernels take the component
  whose range encloses their operator: ranges this tool opens with forward
  hooks on the model's children and around ``ops/matching.py::
  solve_matching``, and the train step's own ``train_step/*`` ranges
  (train/steps.py). A backward kernel takes the component of the forward
  operator that created its autograd node (the profiler's sequence
  numbers);
- and by phase of the train step (``train_step/forward``,
  ``loss_and_matching``, ``backward``, ``optimizer``).

Each device kernel is anchored to the host call that launched it (the
runtime call with its correlation id). It also prints the device's busy
share of the profiled window (the kernels' summed time over the window's
host-clock time, the last step ending in a synchronisation), the top
kernels, and last one line ``PROFILE_STEP
{json}`` with every table, the card's name and power limit. ``--logdir``
writes the profiler's Chrome trace there. Run it in a process of its own:
a profiler, once attached, slows every later launch of its process.
Without a CUDA card it raises.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

WARMUP_STEPS = 2
PHASES = ("train_step/forward", "train_step/loss_and_matching",
          "train_step/backward", "train_step/optimizer")
COMPONENTS = ("backbone", "neck", "det_transformer", "heads", "matcher",
              "match_costs+loss", "optimizer", "other")
_RANGE = "component/"
# the train step's own ranges that name a component
_PHASE_COMPONENTS = {"train_step/loss_and_matching": "match_costs+loss",
                     "train_step/optimizer": "optimizer"}

# Kernel name -> category, the first rule that matches wins. The port's
# kernels by their names in csrc/*.cu first; then the library's, by the
# words in the names of the kernels the flagship's profile on an H100 shows
# (cuDNN's convolutions, cuBLAS's nvjet / cutlass GEMMs and its float32
# ffma / simt ones, ATen's elementwise, reduction and copy kernels).
CATEGORY_RULES = (
    ("K1-fwd", ("patchify_fwd",)),
    ("K1-dW", ("patchify_dw", "patchify_partials_sum")),
    ("K2", ("lap_kernel", "lap_columns_kernel")),
    ("K3-fwd", ("attn_fwd",)),
    ("K3-dq", ("attn_dq",)),
    ("K3-dkdv", ("attn_dkdv",)),
    ("cuDNN convolution", ("cudnn", "conv", "fprop", "dgrad", "wgrad")),
    # float32 GEMMs run on the CUDA cores (TF32 is off): cuBLAS's ffma
    # and simt kernels
    ("CUDA-core GEMM", ("ffma", "simt", "sgemm", "gemv")),
    ("tensor-core GEMM", ("gemm", "nvjet", "cutlass", "cublas", "xmma")),
    ("BatchNorm", ("batch_norm", "batchnorm")),
    ("copies", ("memcpy", "memset", "copy", "catarraybatched")),
    ("reduction", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise",)),
)


def categorize(name: str) -> str:
    """The category of a device kernel (or copy) by its name."""
    low = name.lower()
    for category, needles in CATEGORY_RULES:
        if any(n in low for n in needles):
            return category
    return "other"


def component_of_child(name: str) -> Optional[str]:
    """The component of a DETR's (or BoostedDETR's) child module."""
    if name in ("backbone", "neck"):
        return name
    if name.startswith(("encoder", "decoder")):
        return "det_transformer"
    if "_head" in name:
        return "heads"
    return None


@contextlib.contextmanager
def component_ranges(model: torch.nn.Module):
    """Opens a ``component/<name>`` range around each forward of the
    model's children (forward hooks, removed on exit) and a
    ``component/matcher`` range around ``solve_matching``."""
    from boosted_detr_torch.ops import matching

    open_ranges = []

    def enter(comp):
        def hook(module, args):
            rf = record_function(_RANGE + comp)
            rf.__enter__()
            open_ranges.append(rf)
        return hook

    def leave(module, args, out):
        open_ranges.pop().__exit__(None, None, None)

    handles = []
    for name, child in model.named_children():
        comp = component_of_child(name)
        if comp is not None:
            handles.append(child.register_forward_pre_hook(enter(comp)))
            handles.append(child.register_forward_hook(leave))
    solve = matching.solve_matching

    def solve_in_range(*args, **kw):
        with record_function(_RANGE + "matcher"):
            return solve(*args, **kw)

    matching.solve_matching = solve_in_range
    try:
        yield
    finally:
        matching.solve_matching = solve
        for h in handles:
            h.remove()


def resolutions(image_size: int) -> Tuple[int, ...]:
    """The image's side and its halvings down to stride 32."""
    return tuple(image_size >> k for k in range(6))


def _resolution(shapes, sides: Tuple[int, ...]) -> Optional[int]:
    best = None
    for shape in shapes:
        if not isinstance(shape, (list, tuple)):
            continue
        for a, b in zip(shape, shape[1:]):
            if a == b and a in sides and (best is None or a > best):
                best = a
    return best


def _contexts(events, sides: Tuple[int, ...]):
    """For each event (by id): the innermost component range, backward
    node and spatial resolution enclosing it on its thread (itself
    included), each None where there is none."""
    memo = {}

    def ctx(e):
        if id(e) in memo:
            return memo[id(e)]
        comp, node, res = (ctx(e.cpu_parent) if e.cpu_parent is not None
                           else (None,) * 3)
        name = e.name
        if name.startswith(_RANGE):
            comp = name[len(_RANGE):]
        elif name in _PHASE_COMPONENTS:
            comp = _PHASE_COMPONENTS[name]
        if (name.startswith("autograd::engine::evaluate_function")
                and e.sequence_nr >= 0):
            node = e
        res = _resolution(e.input_shapes or (), sides) or res
        memo[id(e)] = (comp, node, res)
        return memo[id(e)]

    for e in events:
        ctx(e)
    return memo


# a CUDA API call on the host: cudaLaunchKernel, cuLaunchKernel,
# cudaMemcpyAsync, ...
_RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")


def device_units(events) -> List[Tuple[str, float, object]]:
    """Each device kernel and copy of a profile (the device-side copies of
    the ``record_function`` ranges aside): (name, us, the host call that
    launched it, or None). The launch is the runtime call with the
    kernel's correlation id, whose enclosing operators and ranges on its
    thread say what the kernel ran for; a kernel launched from Python
    outside any operator (a ctypes kernel under a range) is found so too."""
    host = torch.autograd.DeviceType.CPU
    device = torch.autograd.DeviceType.CUDA
    calls = {e.id: e for e in events
             if e.device_type == host and _RUNTIME_CALL.match(e.name)}
    return [(e.name, e.time_range.elapsed_us(), calls.get(e.id))
            for e in events
            if e.device_type == device and not e.is_user_annotation]


def attribute(events: Iterable, sides: Tuple[int, ...] = (),
              units: Optional[List[Tuple[str, float, object]]] = None
              ) -> List[Dict[str, object]]:
    """One row for each unit of cost (by default ``device_units``: each
    device kernel, its time in us and the host call that launched it): its
    name, its category, and the resolution, component and phase of the
    host event it is anchored to. A unit under a backward node is in the
    backward phase; any other is in the ``train_step/*`` range whose time
    window holds its host event's start. A unit with no host event reads
    ``unattributed``."""
    events = list(events)
    if units is None:
        units = device_units(events)
    host = torch.autograd.DeviceType.CPU
    events = [e for e in events if e.device_type == host]
    contexts = _contexts(events, sides)
    windows = [(e.time_range.start, e.time_range.end, e.name)
               for e in events if e.name in PHASES]
    forward = {}  # sequence number -> the first forward operator holding it
    for e in events:
        if e.sequence_nr >= 0 and contexts[id(e)][1] is None:
            forward.setdefault(e.sequence_nr, e)
    rows = []
    for name, us, anchor in units:
        row = {"name": name, "category": categorize(name), "us": us}
        if anchor is None:
            row.update(resolution="unattributed", component="unattributed",
                       phase="unattributed")
            rows.append(row)
            continue
        comp, node, res = contexts[id(anchor)]
        if node is not None:
            phase = "train_step/backward"
            if node.sequence_nr in forward:
                comp = contexts[id(forward[node.sequence_nr])][0]
        else:
            t = anchor.time_range.start
            phase = next((ph for a, b, ph in windows if a <= t <= b),
                         "other")
        row.update(resolution=res or "non-spatial",
                   component=comp or "other", phase=phase)
        rows.append(row)
    return rows


def _by(rows, key) -> Dict[str, float]:
    """ms summed by a row key, largest first."""
    out = collections.Counter()
    for r in rows:
        out[str(r[key])] += r["us"] / 1e3
    return dict(out.most_common())


def run_profiled(batch_size: int, steps: int, infer: bool = False,
                 device=None, env=os.environ):
    """Builds the flagship, warms up, then profiles ``steps`` train steps
    (or forwards). Returns ``(profiler, window seconds, image side)``."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.benchmarks import run_benchmarks as rb
    from boosted_detr_torch.train.steps import make_predict_step

    device = rb.resolve_device(device)
    cfg, tcfg, bench_model, _ = rb.flagship_from_env(env)
    tcfg = tcfg.replace(batch_size=batch_size)
    model_cls = bt.BoostedDETR if bench_model == "boosted" else bt.DETR
    model = model_cls(cfg, device=device)
    batch = rb.make_batch(batch_size, cfg, np.random.default_rng(0), device)
    image = batch["image"]
    if infer:
        predict = make_predict_step(model)

        def run(i):
            predict(image + i * 1e-6)
    else:
        state = bt.TrainState.create(model, bt.make_optimizer(
            tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
        step = bt.make_train_step(model, cfg, tcfg)

        def run(i):
            step(state, dict(batch, image=image + i * 1e-6))

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with component_ranges(model):
        for i in range(WARMUP_STEPS):
            run(i)
        rb.synchronize(device)
        with profile(activities=activities, record_shapes=True) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                run(WARMUP_STEPS + i)
            rb.synchronize(device)
            wall = time.perf_counter() - t0
    return prof, wall, cfg.image_size[0]


def report(prof, wall_s: float, steps: int, side: int, top: int,
           card: Dict[str, object]) -> Dict[str, object]:
    """Prints the tables and returns them (per step, ms)."""
    rows = attribute(prof.events(), resolutions(side))
    device_ms = sum(r["us"] for r in rows) / 1e3

    def per_step(d):
        return {k: v / steps for k, v in d.items()}

    out = {"steps": steps, "device_ms_per_step": device_ms / steps,
           "window_ms_per_step": wall_s * 1e3 / steps,
           "busy_share": device_ms / (wall_s * 1e3) if wall_s else None,
           "by_category": per_step(_by(rows, "category")),
           "by_resolution": per_step(_by(rows, "resolution")),
           "by_component": per_step(_by(rows, "component")),
           "by_phase": per_step(_by(rows, "phase")),
           **card}
    print(f"\n== device time {out['device_ms_per_step']:.3f} ms/step in a "
          f"window of {out['window_ms_per_step']:.3f} ms/step (busy "
          f"{100 * (out['busy_share'] or 0):.1f}%) on {card['device']}, "
          f"power limit {card['power_limit_w']} W ==")
    for title, key in (("category", "by_category"),
                       ("activation resolution", "by_resolution"),
                       ("component", "by_component"),
                       ("train-step phase", "by_phase")):
        print(f"\n== device time by {title} (ms/step) ==")
        for name, ms in out[key].items():
            print(f"  {name:22s} {ms:9.3f}")
    print("\n== the port's kernels (ms/step) ==")
    for name, ms in _by(rows, "name").items():
        if categorize(name).startswith("K"):
            print(f"  {ms / steps:9.3f}  [{categorize(name)}] {name}")
    print(f"\n== top {top} kernels (ms/step) ==")
    for name, ms in list(_by(rows, "name").items())[:top]:
        print(f"  {ms / steps:9.3f}  [{categorize(name)}] {name[:200]}")
    print("PROFILE_STEP " + json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    from boosted_detr_torch.benchmarks import run_benchmarks as rb

    ap = argparse.ArgumentParser(
        prog="python -m boosted_detr_torch.benchmarks.profile_step")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--logdir", default=None,
                    help="write the profiler's Chrome trace here")
    ap.add_argument("--infer", action="store_true",
                    help="profile the inference forward instead of the "
                         "train step")
    args = ap.parse_args(argv)
    device = rb.resolve_device()
    prof, wall, side = run_profiled(args.batch, args.steps, args.infer,
                                    device)
    if args.logdir:
        os.makedirs(args.logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.logdir, "trace.json"))
    report(prof, wall, args.steps, side, args.top, rb.card_info(device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
