"""Benchmark harness of the PyTorch/CUDA port: the flagship DETR's train
and inference throughput on one CUDA card (bench.py for
``boosted_detr_torch``).

Run from the root of a checkout: ``python3 bench_torch.py [--steps N]``
(N steps a chunk, ``STEPS_PER_CHUNK`` by default; fewer for a quick
check, as ``chip_smoke.py`` runs it). Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}, with
bench.py's keys, plus ``device``, ``power_limit_w`` (nvidia-smi) and
``kernel_launches`` (each hand-written kernel's launches over the timed
chunks, train and inference).

The model, the batch and the switches are bench.py's
(``run_benchmarks.flagship_from_env``): ``BENCH_BATCH``, ``BENCH_RES``,
``BENCH_BACKBONE``, ``BENCH_STEM``, ``BENCH_NORM``, ``BENCH_PSTEM`` (1: the
stem through K1), ``BENCH_PATTN`` (0: K3 off at 400 tokens;
``BENCH_RES=1280 BENCH_PATTN=1`` runs it over 1600), ``BENCH_SET``,
``BENCH_MODEL=boosted`` and ``BENCH_FBN``.

Timing: chunks of 100 steps by the host clock, each ending in
``torch.cuda.synchronize()``; one warm-up chunk, then three timed chunks
of train steps and three of inference forwards, each reported by its
median chunk. A train step reads ``image + i * 1e-6`` (step i of a chunk,
as bench.py chains its inputs); an inference step copies the image from
pinned host memory to the card, as a server receives it.

Baseline note (bench.py:13-18): the reference publishes no quantitative
numbers. Its training ran on a Colab GPU (T4-class) at roughly 8
images/sec (an estimate from the reference's training diary);
``vs_baseline`` = measured / 8.0.

Without a CUDA card it raises; ``main(device="cpu")`` runs it on the CPU
(the tests, at tiny widths and few steps).
"""

from __future__ import annotations

import json
import os
import statistics

import numpy as np
import torch

TF_COLAB_GPU_IMAGES_PER_SEC = 8.0  # documented estimate, see docstring
STEPS_PER_CHUNK = 100
TIMED_CHUNKS = 3


def main(env=os.environ, device=None, steps: int = STEPS_PER_CHUNK):
    import boosted_detr_torch as bt
    from boosted_detr_torch.benchmarks import run_benchmarks as rb
    from boosted_detr_torch.train.steps import make_predict_step

    device = rb.resolve_device(device)
    card = rb.card_info(device)
    cfg, tcfg, bench_model, batch_size = rb.flagship_from_env(env)
    model_cls = bt.BoostedDETR if bench_model == "boosted" else bt.DETR
    model = model_cls(cfg, device=device)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
    train_step = bt.make_train_step(model, cfg, tcfg)
    predict_step = make_predict_step(model)
    batch = rb.make_batch(batch_size, cfg, np.random.default_rng(0), device)
    image = batch["image"]
    host_image = image.cpu()
    if device.type == "cuda":
        host_image = host_image.pin_memory()

    losses = []

    def train_chunk(_):
        st = state
        for i in range(steps):
            st, aux = train_step(st, dict(batch, image=image + i * 1e-6))
        losses.append(aux["loss"])

    acc = [torch.zeros((), device=device)]

    def infer_chunk(_):
        for i in range(steps):
            x = host_image.to(device, non_blocking=True)
            preds = predict_step(x + i * 1e-6)
            acc[0] = acc[0] + preds["boxes"].float().sum()

    def timed(run_chunk):
        """A warm-up chunk, then the timed ones: (seconds of each, the
        launches over them)."""
        rb.timed_chunks(run_chunk, 1, device)
        before = rb.kernel_launches()
        seconds = rb.timed_chunks(run_chunk, TIMED_CHUNKS, device)
        return seconds, {k: v - before[k]
                         for k, v in rb.kernel_launches().items()}

    train_s, train_launches = timed(train_chunk)
    infer_s, infer_launches = timed(infer_chunk)
    launches = {k: v + infer_launches[k] for k, v in train_launches.items()}
    if not torch.isfinite(acc[0]):
        raise RuntimeError("the inference outputs are not finite")

    step_ms = statistics.median(train_s) * 1e3 / steps
    infer_ms = statistics.median(infer_s) * 1e3 / steps
    train_ips = batch_size * 1e3 / step_ms
    res = cfg.image_size[0]
    line = {
        "metric": f"train_images_per_sec_per_chip_{res}px",
        "value": train_ips,
        "unit": "images/sec/chip",
        "vs_baseline": train_ips / TF_COLAB_GPU_IMAGES_PER_SEC,
        f"inference_images_per_sec_per_chip_{res}px":
            batch_size * 1e3 / infer_ms,
        "train_step_ms": step_ms,
        "train_step_ms_per_chunk": [s * 1e3 / steps for s in train_s],
        "inference_ms_per_chunk": [s * 1e3 / steps for s in infer_s],
        "steps_per_chunk": steps,
        "final_loss": float(losses[-1]),
        "batch_size": batch_size,
        "model": bench_model,
        "backbone": cfg.backbone,
        **card,
        "kernel_launches": launches,
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=STEPS_PER_CHUNK,
                        help="steps a chunk")
    main(steps=parser.parse_args().steps)
