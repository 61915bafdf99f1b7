"""Benchmark suite of the port: train throughput, the matchers, and the
other model families, on one CUDA card.

Run: ``python -m boosted_detr_torch.benchmarks.run_benchmarks [--quick]``
(or ``python -m boosted_detr_torch.cli benchmark [--quick]``, which runs
the matchers and the throughput configurations).

The counterpart of benchmarks/run_benchmarks.py: the same nine throughput
configurations under the same names (``train_<name>``), the same batches
(``make_batch``: the same numpy draws in the same order, one generator
shared across the configurations in list order), the matchers at
[8, 32, 96] from seed 1, and the panoptic model and the pre-trainer on the
``patchify8`` flagship. Three matcher names said which XLA program they
timed; here they name what runs on the card:

- ``matcher_hungarian_xla`` -> ``matcher_hungarian_plain``: the plain
  exact solver, ``matcher="hungarian"`` (``ops/lap.py::
  hungarian_lap_reference``);
- ``matcher_hungarian_pallas`` -> ``matcher_hungarian_kernel``: the exact
  solver's CUDA kernel (K2, ``ops/lap.py::hungarian_lap``);
- ``matcher_auction_xla`` -> ``matcher_auction`` (``ops/matching.py::
  auction_lap``);
- ``matcher_native_cpp_host`` keeps its name: the host's native solver
  (``native/lap_binding``).

Timing on the card: at least ``WARMUP_STEPS`` steps first (the kernels are
built and loaded, cuDNN has chosen its algorithms), then ``CHUNKS`` chunks
of ``STEPS_PER_CHUNK`` steps (``SOLVES_PER_CHUNK`` solves for a matcher)
by the host clock, each chunk ending in ``torch.cuda.synchronize()``. Each
line reports the median chunk as its value, with the quartiles and the
counts (``chunks``, ``steps_per_chunk``) beside it. The inputs are
chained by content as in the JAX suite (step i trains on ``image + i *
1e-6``; a matcher solves ``c + i * 1e-7`` and then moves ``c`` by
``m * 1e-6``), so that ``loss`` is the loss of the same run of steps.
Every line names its ``device`` and the card's ``power_limit_w`` (from
nvidia-smi), and carries ``kernel_launches``: how many times each
hand-written kernel's wrapper launched over the timed chunks.

Without a CUDA card every entry point raises; the CPU is used only when
the caller passes ``device="cpu"``, as the tests do at tiny widths
(``overrides``) and counts (``chunks``, ``steps``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

WARMUP_STEPS = 2
CHUNKS = 5
STEPS_PER_CHUNK = 10
SOLVES_PER_CHUNK = 20
BATCH = 8
MATCHER_SHAPE = (8, 32, 96)
MASK_SIZE = 96

# Each hand-written kernel and its wrapper (module under
# boosted_detr_torch/ops, function), whose ``launches`` counts the
# wrapper's launches on the card.
KERNEL_WRAPPERS = {
    "patchify_fwd": ("patchify", "patchify_conv"),          # K1-fwd
    "patchify_dw": ("patchify", "patchify_conv_dw"),        # K1-dW
    "lap": ("lap", "hungarian_lap"),                        # K2
    "attention_fwd": ("attention", "attention_fwd"),        # K3-fwd
    "attention_dq": ("attention", "attention_dq"),          # K3-dq
    "attention_dkdv": ("attention", "attention_dkdv"),      # K3-dkdv
}

# benchmarks/run_benchmarks.py:84-124: (name, ModelConfig fields, model
# class, batch size), in its order.
THROUGHPUT_CONFIGS = (
    ("detr_resnet_640", dict(image_size=(640, 640), backbone="resnet",
                             compute_dtype="bfloat16", max_objects=32),
     "DETR", 8),
    ("detr_resnet_patchify_640",  # bench.py's flagship of an earlier round
     dict(image_size=(640, 640), backbone="resnet", compute_dtype="bfloat16",
          max_objects=32, matcher="pallas", stem="patchify"), "DETR", 8),
    ("detr_resnet_patchify8_640",  # skips the 160px stage
     dict(image_size=(640, 640), backbone="resnet", compute_dtype="bfloat16",
          max_objects=32, matcher="pallas", stem="patchify8"), "DETR", 8),
    ("detr_vit_640", dict(image_size=(640, 640), backbone="vit",
                          compute_dtype="bfloat16", max_objects=32,
                          matcher="pallas"), "DETR", 8),
    ("detr_resnet_560", dict(image_size=(560, 560), backbone="resnet",
                             compute_dtype="bfloat16", max_objects=32),
     "DETR", 8),
    ("detr_effnetlite_640", dict(image_size=(640, 640),
                                 backbone="efficientnet_lite",
                                 compute_dtype="bfloat16", max_objects=32),
     "DETR", 8),
    ("detr_effnetb4_640", dict(image_size=(640, 640),
                               backbone="efficientnet_b4",
                               compute_dtype="bfloat16", max_objects=32,
                               matcher="pallas"), "DETR", 8),
    ("boosted_resnet_640", dict(image_size=(640, 640), backbone="resnet",
                                compute_dtype="bfloat16", max_objects=32),
     "BoostedDETR", 8),
    ("boosted_resnet_patchify8_640",  # boosted on the flagship stem
     dict(image_size=(640, 640), backbone="resnet", compute_dtype="bfloat16",
          max_objects=32, matcher="pallas", stem="patchify8"),
     "BoostedDETR", 8),
)

# benchmarks/run_benchmarks.py:233-235: the panoptic model and the
# pre-trainer train on this configuration.
OTHER_MODELS_CONFIG = dict(image_size=(640, 640), backbone="resnet",
                           compute_dtype="bfloat16", max_objects=32,
                           matcher="pallas", stem="patchify8")


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device. Without a card a
    benchmark raises: it measures the card and never runs on the CPU in its
    place."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "benchmark: no CUDA card (torch.cuda.is_available() is False); "
            "a benchmark measures the card and does not fall back to the "
            "CPU: pass device='cpu' (--device cpu) to run it there")
    return dev


def card_info(device: torch.device) -> Dict[str, object]:
    """``device``: the card's name (or ``cpu``); ``power_limit_w``: its
    power limit as nvidia-smi reads it (None on the CPU, or where
    nvidia-smi does not answer)."""
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None else 0
    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        limit = float(out[index].rsplit(",", 1)[1].strip().split()[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        pass
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": limit}


def kernel_launches() -> Dict[str, int]:
    """Each hand-written kernel's launch count so far in this process."""
    out = {}
    for name, (module, wrapper) in KERNEL_WRAPPERS.items():
        mod = importlib.import_module(f"boosted_detr_torch.ops.{module}")
        out[name] = getattr(mod, wrapper).launches
    return out


def _launches_since(before: Mapping[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def make_batch(bs: int, cfg, rng: np.random.Generator,
               device) -> Dict[str, torch.Tensor]:
    """A random detection batch (benchmarks/run_benchmarks.py:59-75): the
    same draws from ``rng`` in the same order, as tensors on ``device``."""
    h, w = cfg.image_size
    batch = {
        "image": rng.uniform(0, 1, (bs, h, w, 3)).astype(np.float32),
        "category_ids": rng.integers(
            2, cfg.num_categories, (bs, cfg.max_objects)).astype(np.int32),
        "attribute_ids": rng.integers(
            0, cfg.num_attributes, (bs, cfg.max_objects, 4)).astype(np.int32),
        "bbox": rng.uniform(0.05, 0.45,
                            (bs, cfg.max_objects, 4)).astype(np.float32),
        "num_objects": rng.integers(1, cfg.max_objects + 1,
                                    (bs,)).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def synchronize(device: torch.device) -> None:
    """Waits for the card's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_chunks(run_chunk: Callable[[int], object], chunks: int,
                 device: torch.device) -> List[float]:
    """Seconds of each of ``chunks`` calls ``run_chunk(c)`` by the host
    clock, each ending in a synchronisation with the card."""
    seconds = []
    for c in range(chunks):
        t0 = time.perf_counter()
        run_chunk(c)
        synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def summary(seconds: Sequence[float], per_chunk: int,
            key: str) -> Dict[str, object]:
    """The median chunk's ms a step as ``key``, the quartiles beside it
    (``key``_q1, ``key``_q3) and the counts."""
    ms = [s * 1e3 / per_chunk for s in seconds]
    q1, med, q3 = statistics.quantiles(ms, n=4, method="inclusive")
    return {key: med, f"{key}_q1": q1, f"{key}_q3": q3,
            "chunks": len(seconds), "steps_per_chunk": per_chunk}


def _train_line(name: str, step, state, batch, card, device, chunks: int,
                steps: int, warmup: int) -> Dict[str, object]:
    """Times ``step(state, batch)`` (a train step of the port) with the
    image chained by content, and returns the line of ``train_<name>``."""
    image = batch["image"]
    for i in range(warmup):
        state, aux = step(state, dict(batch, image=image + i * 1e-6))
    synchronize(device)
    before = kernel_launches()
    last = {}

    def run_chunk(_):
        st = state
        for i in range(steps):
            st, aux = step(st, dict(batch, image=image + i * 1e-6))
        last["loss"] = aux["loss"]

    seconds = timed_chunks(run_chunk, chunks, device)
    launches = _launches_since(before)
    line = {"benchmark": f"train_{name}",
            **summary(seconds, steps, "ms_per_step")}
    bs = int(image.shape[0])
    line.update(images_per_sec=bs * 1e3 / line["ms_per_step"],
                batch_size=bs, loss=float(last["loss"]), **card,
                kernel_launches=launches)
    return line


def _emit(line: Mapping[str, object]) -> None:
    print(json.dumps(line), flush=True)


def bench_throughput(quick: bool = False, device=None,
                     overrides: Optional[Mapping[str, object]] = None,
                     chunks: int = CHUNKS, steps: int = STEPS_PER_CHUNK,
                     warmup: int = WARMUP_STEPS) -> List[Dict[str, object]]:
    """Train throughput of the nine configurations of
    ``THROUGHPUT_CONFIGS`` (the first alone with ``quick``): one line each,
    ``train_<name>``. ``overrides`` replaces ModelConfig fields of every
    configuration (the tests' tiny widths)."""
    import boosted_detr_torch as bt

    device = resolve_device(device)
    card = card_info(device)
    rng = np.random.default_rng(0)
    lines = []
    configs = THROUGHPUT_CONFIGS[:1] if quick else THROUGHPUT_CONFIGS
    for name, fields, model_cls, bs in configs:
        cfg = bt.ModelConfig(**dict(fields, **(overrides or {})))
        boosted = model_cls == "BoostedDETR"
        tcfg = bt.TrainConfig(batch_size=bs, use_intermediate_losses=boosted)
        model = getattr(bt, model_cls)(cfg, device=device)
        state = bt.TrainState.create(model, bt.make_optimizer(
            tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
        line = _train_line(name, bt.make_train_step(model, cfg, tcfg), state,
                           make_batch(bs, cfg, rng, device), card, device,
                           chunks, steps, warmup)
        _emit(line)
        lines.append(line)
        del model, state
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def bench_matcher(device=None, chunks: int = CHUNKS,
                  solves: int = SOLVES_PER_CHUNK,
                  warmup: int = WARMUP_STEPS) -> List[Dict[str, object]]:
    """``ms_per_solve`` of the exact solver (plain and K2), the auction and
    the host's native solver at ``MATCHER_SHAPE``, from seed 1
    (benchmarks/run_benchmarks.py:138-188)."""
    from boosted_detr_torch.native import lap_binding
    from boosted_detr_torch.ops import lap, matching

    device = resolve_device(device)
    card = card_info(device)
    rng = np.random.default_rng(1)
    b, o, p = MATCHER_SHAPE
    cost_np = rng.uniform(0, 10, (b, o, p)).astype(np.float32)
    n_np = rng.integers(1, o + 1, (b,)).astype(np.int32)
    cost = torch.from_numpy(cost_np).to(device)
    n = torch.from_numpy(n_np).to(device)
    solvers = (
        ("hungarian_plain",
         lambda c, n: matching.solve_matching(c, n, "hungarian")),
        ("hungarian_kernel", lap.hungarian_lap),
        ("auction", matching.auction_lap))
    lines = []
    for name, solver in solvers:
        def chunk(c0, count, solver=solver):
            c = c0
            for i in range(count):
                m = solver(c + i * 1e-7, n)
                c = c + m * 1e-6
            return c

        chunk(cost, warmup)
        synchronize(device)
        before = kernel_launches()
        start = [cost]

        def run_chunk(_, chunk=chunk):
            start[0] = start[0] + 1e-6
            chunk(start[0], solves)

        seconds = timed_chunks(run_chunk, chunks, device)
        lines.append({"benchmark": f"matcher_{name}",
                      **summary(seconds, solves, "ms_per_solve"),
                      "shape": [b, o, p], **card,
                      "kernel_launches": _launches_since(before)})
        _emit(lines[-1])

    for _ in range(warmup):  # the first call builds the library
        lap_binding.lap_solve_batch(cost_np, n_np)
    before = kernel_launches()
    seconds = timed_chunks(
        lambda _: [lap_binding.lap_solve_batch(cost_np, n_np)
                   for _ in range(solves)], chunks, torch.device("cpu"))
    lines.append({"benchmark": "matcher_native_cpp_host",
                  **summary(seconds, solves, "ms_per_solve"),
                  "shape": [b, o, p], **card,
                  "kernel_launches": _launches_since(before)})
    _emit(lines[-1])
    return lines


def other_models_batch(bs: int, cfg, rng: np.random.Generator, device,
                       mask_size: int = MASK_SIZE):
    """``make_batch``'s batch, then the panoptic batch: the same with
    ``masks`` [B, O, S, S] of random 0/1 drawn after it
    (benchmarks/run_benchmarks.py:237-241)."""
    batch = make_batch(bs, cfg, rng, device)
    masks = rng.integers(0, 2, (bs, cfg.max_objects, mask_size, mask_size))
    return batch, dict(batch, masks=torch.from_numpy(
        masks.astype(np.float32)).to(device))


def bench_other_models(device=None,
                       overrides: Optional[Mapping[str, object]] = None,
                       chunks: int = CHUNKS, steps: int = STEPS_PER_CHUNK,
                       warmup: int = WARMUP_STEPS
                       ) -> List[Dict[str, object]]:
    """Train throughput of the panoptic model (mask size 96) and the
    classifier pre-trainer on the ``patchify8`` flagship
    (benchmarks/run_benchmarks.py:220-268)."""
    import boosted_detr_torch as bt

    device = resolve_device(device)
    card = card_info(device)
    rng = np.random.default_rng(0)
    bs = BATCH
    cfg = bt.ModelConfig(**dict(OTHER_MODELS_CONFIG, **(overrides or {})))
    tcfg = bt.TrainConfig(batch_size=bs)
    batch, pbatch = other_models_batch(bs, cfg, rng, device)

    def state_of(model):
        return bt.TrainState.create(model, bt.make_optimizer(
            tcfg, model.named_parameters(), d_model=cfg.decoder_dim))

    lines = []
    pano = bt.DETRPanoptic(cfg, mask_size=MASK_SIZE, device=device)
    lines.append(_train_line(
        "panoptic_resnet_patchify8_640", bt.make_panoptic_train_step(
            pano, tcfg), state_of(pano), pbatch, card, device, chunks,
        steps, warmup))
    _emit(lines[-1])
    del pano
    pre = bt.DETRMultiClassifier(cfg, num_classifier_classes=cfg.num_categories,
                                 device=device)
    lines.append(_train_line(
        "pretrainer_resnet_patchify8_640", bt.make_pretrain_step(pre),
        state_of(pre), batch, card, device, chunks, steps, warmup))
    _emit(lines[-1])
    return lines


def parse_set(kv: str):
    """One ``key=value`` of ``BENCH_SET`` (bench.py:78-87): an int, a
    float, True/False, or the string."""
    key, _, val = kv.partition("=")
    for cast in (int, float):
        try:
            return key, cast(val)
        except ValueError:
            pass
    if val in ("True", "False"):
        return key, val == "True"
    return key, val


def flagship_from_env(env: Mapping[str, str]):
    """bench.py's flagship (bench.py:46-108) under its switches in ``env``:
    ``BENCH_BATCH`` (8), ``BENCH_RES`` (640), ``BENCH_BACKBONE`` (resnet),
    ``BENCH_STEM`` (patchify8), ``BENCH_NORM`` (batchnorm), ``BENCH_PSTEM``
    (1: the stem through K1), ``BENCH_PATTN`` (0: K3 off; 1 at
    ``BENCH_RES=1280`` runs it over 1600 tokens), ``BENCH_SET`` (ModelConfig
    overrides, ``k=v,...``), ``BENCH_MODEL`` (detr, or boosted: the
    ensemble with intermediate losses) and ``BENCH_FBN`` (0; 1 freezes the
    BatchNorm statistics). Returns ``(ModelConfig, TrainConfig, model
    name, batch size)``."""
    from boosted_detr_torch.config import ModelConfig, TrainConfig

    batch_size = int(env.get("BENCH_BATCH", "8"))
    res = int(env.get("BENCH_RES", "640"))
    cfg = ModelConfig(
        image_size=(res, res), backbone=env.get("BENCH_BACKBONE", "resnet"),
        compute_dtype="bfloat16", max_objects=32, matcher="pallas",
        stem=env.get("BENCH_STEM", "patchify8"),
        norm=env.get("BENCH_NORM", "batchnorm"),
        use_pallas_stem=bool(int(env.get("BENCH_PSTEM", "1"))),
        use_pallas_attention=bool(int(env.get("BENCH_PATTN", "0"))))
    if env.get("BENCH_SET"):
        cfg = cfg.replace(**dict(parse_set(kv)
                                 for kv in env["BENCH_SET"].split(",")))
    model = env.get("BENCH_MODEL", "detr")
    fbn = bool(int(env.get("BENCH_FBN", "0")))
    tcfg = TrainConfig(batch_size=batch_size, freeze_bn_stats=fbn,
                       use_intermediate_losses=model == "boosted")
    return cfg, tcfg, model, batch_size


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m boosted_detr_torch.benchmarks.run_benchmarks")
    parser.add_argument("--quick", action="store_true",
                        help="the first throughput configuration only, and "
                             "no other models")
    args = parser.parse_args(argv)
    bench_matcher()
    bench_throughput(args.quick)
    if not args.quick:
        bench_other_models()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
