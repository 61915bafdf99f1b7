"""Chip smoke test of the PyTorch port on one CUDA card (an H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. build: compiles every hand-written kernel under boosted_detr_torch/csrc/
   (patchify.cu, lap.cu, attention.cu) with nvcc for sm_90a, one process
   per source, all at once, and prints ptxas's registers and spill bytes
   of every K3 instantiation (3 kernels, 2 dtypes, D = 32, 64, 80 and 128,
   in bf16 the forward, dq and dk/dv on wgmma at all four, dq on mma.sync
   at 32 and dk/dv at 32 and 64, the chunked wide kernels for D = 128 n,
   n >= 2, the resident bf16 forward, dq and dk/dv at D = 256 and 384, and
   the float32 TF32 dq and dk/dv at D = 256) and the wgmma kernels', the
   wide bf16 kernels' and the TF32 kernels' blocks an SM;
2. kernels: calls each kernel's wrapper on the card at the shapes the main
   paths give it (and the port's other stem shapes): the stem's forward
   (K1-fwd) and weight gradient (K1-dW), each with bf16 weights on the
   tensor cores and float32 weights and the P=4 stem on the CUDA cores
   (also at W = 4096 and 8192, where a block takes a span of a row), the
   exact matcher (K2; also at 300 queries, 120 objects and 1023 columns,
   and on its columns route at DINO's 900 queries with 120 objects and at
   2065 columns, each row naming its kernel and held against its route's
   serial-chain yardstick), and the fused
   attention's forward with its lse (K3-fwd), dq (K3-dq) and dk/dv
   (K3-dkdv) in bf16 (on the tensor cores) and float32 (on the CUDA
   cores; dq and dk/dv at a padded D = 256 on the tensor cores as three
   TF32 products a product, each named, launched twice for the same bits
   and held against its emulation too, SDPA's own float32 differences
   printed on every float32 row), up to D = 512 (in bf16 up to D = 128
   the forward, dq and dk/dv on the wgmma kernels, dq at D = 32 and
   dk/dv at D <= 64 on mma.sync over short streams, each also launched
   twice for the same bits and
   held against its emulation, SDPA timed as ``device_ms`` too; past 128
   on the resident kernels at 256 and 384 and on the chunked ones at
   512);
   holds each
   result against the plain PyTorch version on the same inputs, and times
   kernel, plain version and one PyTorch library call (where one computes
   the same function) with CUDA events;
   for K3 also the backward alone (delta, dq and dk/dv through the autograd
   Function) beside the library's; then the matchers that are not kernels
   (the auction, the greedy matcher and scipy's on the host) on CUDA
   tensors against K2;
3. the main paths, each built from seeded random weights (and random
   running statistics for serving) at full width, every launch counter set
   to 0 just before the path runs and read just after:
   - flagship serving: DETR at 640x640, batch 8, bf16, ResNet patchify8
     stem through K1, a few requests through ``predict``, outputs checked,
     the same model with its stem on the plain version; then where one
     request's time goes;
   - flagship training: the train step of bench.py (live BatchNorm,
     dropout 0.1, the matched loss through K2, SGD with Nesterov momentum
     and per-tensor clipnorm) on the batch bench.py builds: warm-up steps,
     timed steps, a profile of one step, and the same step from one state
     with the kernels, with the plain versions (the losses held together),
     and with the plain forward but the backward kernels (the gradients
     held against the plain step's);
   - the same two at 1280x1280 with ``use_pallas_attention`` (1600 encoder
     tokens: K3 in every attention, against the plain K1 and K3 versions);
   - the same two for the ViT-p16 backbone at 640x640 (width 384, depth 8,
     6 heads: K1 at P=16 -> 384 and K3 in the ViT blocks and in DETR);
   - the same two at ViT-Huge's widths (``vit_h16``: depth 32, width 1280,
     16 heads of D = 80, which K3 takes as built; 651,553,406 parameters):
     K1 at P=16 -> 1280, K3 43 times a forward (32 blocks at
     [128, 1600, 1600, 80] and DETR's 11 at D = 32, all on
     ``attn_fwd_wgmma_kernel``), with each path's peak device memory; on
     every path that runs K3 the forward kernels are held by name in the
     served forward's and the train step's profiles;
   - the same two at ViT-Large's depth and widths over 4 heads
     (``vit_l16_h4``: depth 24, width 1024, MLP 4096, D = 256;
     318,726,526 parameters): K1 at P=16 -> 1024, K3 35 times a forward
     (24 blocks at [32, 1600, 1600, 256] on the wide kernels, DETR's 11 at
     D = 32);
   - ``vit_l16_h4`` in float32 (``vit_l16_h4_f32``,
     ``compute_dtype="float32"``), trained only (one warm-up and three
     timed steps, within the run's time limit): the 24 blocks' dq and
     dk/dv on the TF32 kernels, held by name and count in the train step's
     profile, the forward and DETR's 11 attentions on the float32
     CUDA-core kernels; its step, busy share, K3's device ms by kernel and
     peak memory;
   - one train step of the 640 flagship at DINO's 900 queries and
     ``max_objects=120`` (``flagship_900q``): K2 once on its columns route
     at [8, 120, 900], the loss held to the plain step's;
   - the boosted ensemble (``BoostedDETR``) at the 640 flagship's widths:
     serving as above, plus one early-exit request (stability criterion)
     and one incremental request (all 4 weak learners), each held against
     the full forward, and one incremental request (stability) on a model
     built for each of the carry, confidence and shared-encoder modes,
     held against that model's full forward at its exit block; the joint
     train step with intermediate losses (the
     4 blocks' matching folded into one K2 launch at [32, 32, 96]) as
     above; then staged steps that train weak learner 1 alone (the frozen
     backbone's weight gradient is never launched; every frozen parameter
     held bit for bit);
   - the norm-free 640 flagship (``norm="skipinit"``, bench.py's
     BENCH_NORM=skipinit): weight-standardised convs, K1 on standardised
     weights (its gradient back through the standardisation to the
     stem's weight and gain, both held to move), ``skip_gain`` on every
     residual branch (drawn from a seeded normal before serving and
     training, so that no branch sits at its zero init), GroupNorm in the
     neck, no norm in the heads;
   - the EfficientNet-B4 backbone at 640 (bench.py's
     BENCH_BACKBONE=efficientnet_b4: 32 MBConvSE blocks, stochastic depth
     in training) and ``ModelConfig()``'s default EfficientNet-lite model
     at 560: no hand-written kernel in their forward, K2 in their step;
     each path with a parameter count pins it to the JAX model's
     (``jax.eval_shape`` on the CPU);
   - the panoptic model (``DETRPanoptic``, mask size 96) and the
     classifier pre-trainer (``DETRMultiClassifier`` over the 82
     categories) on the 640 flagship's config, as
     benchmarks/run_benchmarks.py:219-269 trains them: the panoptic
     requests served raw with their masks, segmented, one decoded to
     text; its step the detection and mask losses on one K2 assignment,
     on a batch with box masks; the pre-trainer's requests its class
     probabilities, its step the classifier loss after every block (no
     K2);
   - the trainer: the training loop as users run it, on the 640
     flagship's config: SyntheticShapes' hard preset through ``Pipeline``
     and ``prefetch_to_device`` into ``Trainer.fit`` with ``augment_batch``
     on the card as its ``batch_fn``, validation, a CSV log and
     checkpoints (host-fed), and ``make_batch_fn`` rendering every batch
     on the card (device-fed); gates: launches per fit step, eval step and
     predict forward, the Trainer's step against ``make_train_step``'s and
     ``scan_steps=2`` against 1 bit for bit, a restored Trainer and one
     further step bit for bit, ``rasterize`` and the augmentations on the
     card against the CPU, prefetched batches against the iterator's, the
     NaN guard, ``evaluate``, ``predict`` and ``evaluate_map``; reports the
     fit step's time and device-busy share on both routes, the pinned and
     pageable copies of one batch and the time to render one;
   - api_serving: the user's front door on the 640 flagship's config:
     ``api.DETR`` compiled and fitted (3 steps on SyntheticShapes.hard
     frames), ``save`` and ``load_model`` bit for bit, ``export_serving``
     (a ``torch.export`` program that keeps K1-fwd and K3-fwd as registered
     ops) and ``load_serving``, 3 requests to the artifact (K1-fwd counted
     once each inside it; raw outputs against the live model at 5e-2, the
     decoded text equal); ``api.BoostedDETR`` early-exit artifacts in both
     criteria (full depth at the default threshold, a middle threshold's
     exit blocks as ``predict``'s) and an EMA artifact; a ViT-p16 artifact
     (K3-fwd 19 a request); the CLI's train, evaluate and export in this
     process (K2 in its steps); reports each export's seconds and
     ``model.pt2`` size and an artifact request's host time beside the
     live request's;
   - parallel: training across processes (boosted_detr_torch/parallel/).
     Two ranks, each a process of this script (``parallel-rank``), share
     the card over gloo with CUDA tensors (NCCL refuses two ranks on one
     device); the one-process references run first, in this process.
     Data parallelism on the 640 flagship, 4 rows a rank against one
     process on 8: the kernel step's loss at the 1e-3 noise gate, K1-fwd,
     K1-dW and K2 (at [4, 32, 96]) launched on each rank, both ranks'
     parameters bit for bit, and the reduced gradients of one step at
     calibrated, frozen statistics with the plain forward and the
     backward kernels within 5e-2 of their norm (bf16, all leaves;
     float32, all leaves and the stem's); a small float32 model (dropout
     0.1, live BatchNorm) at the small models' gates; context-parallel
     attention through K3 at the 1280 encoder's shape (two shards of 800
     keys) against the one-process K3 and the plain version; the 1280
     flagship with K3 split over 'model' (4 heads a rank), its forward at
     the serving gate and one step's finite loss; two ``cli train
     --coordinator`` processes that print the same final loss; and one
     rank under NCCL whose step equals the step without a process group
     bit for bit. Reports each rank's step time, the gradients'
     all-reduce time with its bytes, and the context-parallel merge's
     time, and K3's row at the per-shard shape [64, 1600, 800, 32];
   - benchmarks: the benchmark suite as users run it, each command in a
     process of its own: ``python -m boosted_detr_torch.cli benchmark
     --quick`` (the matchers at [8, 32, 96] and the first throughput
     configuration), ``bench_torch.py --steps 20`` (the 640 flagship's
     train and inference throughput, 20 steps a chunk) and
     ``boosted_detr_torch.benchmarks.
     profile_step --steps 2``; every expected line names the card and its
     power limit and has positive, finite times, K2 launched on the kernel
     matcher's line and not on the plain one's, bench_torch.py launched
     K1-fwd, K1-dW and K2 and no K3, and the profile attributed K1, K2
     and every component;
4. small reference: small float32 models on the card against the same
   weights on the CPU, the path the CPU tests hold against JAX (the
   ResNet DETR with plain attention, the same with the fused attention,
   a ViT DETR, a boosted ensemble with carried queries and the fused
   attention, an EfficientNet-lite DETR, a narrow B4 DETR with stochastic
   depth drawn from one CPU generator on both sides, a tiny DETR with
   GroupNorm, a conv7 ResNet DETR, a norm-free DETR trained with the
   adaptive gradient clip, a DETRPanoptic, a DETRMultiClassifier, and the
   ResNet DETR with the auction and with the greedy matcher): one forward,
   and one train step with the model's own step builder;
5. kernel names: which device kernel each forward and each weight
   gradient of phase 2 runs, from a profile (tensor cores for bf16, CUDA
   cores for float32 and the P=4 stem), in a process of its own
   (``chip_smoke.py kernel-names``); a bf16 path's profiled forward is
   held to the same in phase 3;
6. report: the card's name and power limit, a ``kernels`` JSON line, and
   the last line ``{"ok": true, "device": {...}}``.

TF32 is off for matmuls and convolutions, so that every float32 comparison
is float32. Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA's data sheet, dense): bytes/s of HBM3 and
# operations/s by operand type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# the TF32 rate of the tensor cores: the float32 dq and dk/dv at D = 256
# run on them as three TF32 products a product, and their ``bound_ms`` is
# that work at this rate (the CUDA-core figure stays beside it as
# ``bound_cuda_core_ms``)
TF32_OPS_PER_S = 495e12
# how far the TF32 kernels' dq, dk and dv may lie from the emulation of
# their arithmetic, of the largest value: the tensor cores add truncating
# where the emulation rounds (tests/test_torch_attention_kernel.py,
# TF32_EMULATION_GATE; dq's 3.4e-5 at [32, 1600, 1600, 256] is the most
# measured, PERF.md)
TF32_EMULATION_GATE = 1e-4
# ex2.approx results a clock on an SM (the special-function units; the CUDA
# C++ Programming Guide's throughput table, compute capability 9.0): each
# bf16 K3 kernel takes one a query-key pair for p
EX2_PER_CLOCK_PER_SM = 16
WARMUP, REPEATS = 3, 25
# cycles of the card's clock (about half a millisecond) that it spins before
# a launch timed as ``device_ms``
SPIN_CYCLES = 1_000_000
REQUESTS, BATCH, RES = 3, 8, 640
TRAIN_WARMUP, TRAIN_STEPS = 3, 10
# the 1280px and ViT paths: fewer steps, each several times the 640px one
HR_RES, HR_TRAIN_WARMUP, HR_TRAIN_STEPS = 1280, 2, 5
# Every kernel: its module under boosted_detr_torch/ops, its wrapper, its
# plain version, its source, and the TPU kernel it replaces.
KERNELS = {
    "patchify_fwd": ("patchify", "patchify_conv", "patchify_conv_reference",
                     "boosted_detr_torch/csrc/patchify.cu",
                     "boosted_detr_tpu/ops/pallas_patchify.py:122"),
    "patchify_dw": ("patchify", "patchify_conv_dw",
                    "patchify_conv_dw_reference",
                    "boosted_detr_torch/csrc/patchify.cu",
                    "boosted_detr_tpu/ops/pallas_patchify.py:152"),
    "lap": ("lap", "hungarian_lap", "hungarian_lap_reference",
            "boosted_detr_torch/csrc/lap.cu",
            "boosted_detr_tpu/ops/pallas_lap.py:160"),
    "attention_fwd": ("attention", "attention_fwd", "attention_fwd_reference",
                      "boosted_detr_torch/csrc/attention.cu",
                      "boosted_detr_tpu/ops/pallas_attention.py:112"),
    "attention_dq": ("attention", "attention_dq", "attention_dq_reference",
                     "boosted_detr_torch/csrc/attention.cu",
                     "boosted_detr_tpu/ops/pallas_attention.py:233"),
    "attention_dkdv": ("attention", "attention_dkdv",
                       "attention_dkdv_reference",
                       "boosted_detr_torch/csrc/attention.cu",
                       "boosted_detr_tpu/ops/pallas_attention.py:257"),
}
# Tensor-core passes over a pair of tiles in the bf16 kernels: the first
# products once, and each second product twice (p and ds enter as two bf16
# values, hi + lo), against 2, 3 and 4 products in the work itself; the
# resident wide forward at D = 384 computes the logits in both of its
# warpgroups, one more pass (``_k3_passes``).
K3_PASSES = {"fwd": 3, "dq": 4, "dkdv": 6}


def _k3_passes(name, d):
    from boosted_detr_torch.ops import attention as A

    padded = A.padded_head_dim(d)
    twice = (name == "fwd" and 2 * A.CHUNK < padded
             <= A.RESIDENT_MAX_HEAD_DIM)
    return K3_PASSES[name] + twice
# K1-fwd's cases: (patch, C_out, weights' dtype, seed, resolution: a side,
# or (height, width)). The 640 flagship's stem first (the ``kernels``
# line's row), the ViT patch embed, the 1280px stem (Wo = 160), ViT-Huge's
# patch embed (1280 channels: three blocks of 384 and a partial one of
# 128) and ViT-Large's (P=16 -> 1024); then the CUDA-core kernel at widths
# whose P whole rows pass its shared memory (a block takes a span of a
# row): float32 weights at P=16 -> 384 and W = 4096, and the P=4 stem's
# float32 weights at W = 8192.
WIDE_RES = {16: (256, 4096), 4: (256, 8192)}
K1_CASES = ((8, 128, torch.bfloat16, 0, RES), (8, 128, torch.float32, 1, RES),
            (4, 64, torch.bfloat16, 2, RES), (16, 384, torch.bfloat16, 3, RES),
            (8, 128, torch.bfloat16, 30, HR_RES),
            (16, 1280, torch.bfloat16, 32, RES),
            (16, 1024, torch.bfloat16, 34, RES),
            (16, 384, torch.float32, 36, WIDE_RES[16]),
            (4, 64, torch.float32, 38, WIDE_RES[4]))
# K1-dW's cases, as K1_CASES: the 640 stem's first (the ``kernels`` line's
# row); bf16 on the tensor cores, float32 and the P=4 stem on the CUDA cores.
DW_CASES = ((8, 128, torch.bfloat16, 4, RES), (8, 128, torch.float32, 5, RES),
            (4, 64, torch.bfloat16, 6, RES), (16, 384, torch.bfloat16, 7, RES),
            (8, 128, torch.bfloat16, 31, HR_RES),
            (16, 1280, torch.bfloat16, 33, RES),
            (16, 1024, torch.bfloat16, 35, RES),
            (16, 384, torch.float32, 37, WIDE_RES[16]),
            (4, 64, torch.float32, 39, WIDE_RES[4]))
# K2's cases: (B, O, P, seed, edges); the flagship's first (the ``kernels``
# line's row), then four boosted blocks folded into one launch, 300 queries,
# the most rows the kernel takes, and the most columns of the slots route;
# then the columns route: DINO's 900 queries at max_objects=120 (the
# flagship_900q step's problem; 432 KB of cost rows) and C = 2065.
K2_CASES = ((8, 32, 96, 8, False), (8, 32, 96, 9, True),
            (32, 32, 96, 10, True), (8, 32, 300, 40, True),
            (4, 120, 300, 41, True), (2, 32, 990, 42, True),
            (8, 120, 900, 43, True), (2, 64, 2000, 44, True))
# K2's yardstick, the serial chain of the kernel's first design counted
# from its source (PERF.md, section 6): cycles of one Dijkstra step and of
# one step of the walk back, at the H100 SXM's top SM clock.
K2_CHAIN_CYCLES = {"dijkstra": 370, "augmentation": 100}
K2_CHAIN_HZ = 1.98e9
# The columns route's (csrc/lap.cu's lap_columns_kernel<K>), counted from
# its source at K = 4 (the flagship_900q's [8, 120, 900]): the dependent
# chain of a Dijkstra step from i0 to the next i0 is the row's address (4
# cycles), its L2 read (260), the relaxation (two subtractions, a compare
# and two selects: 21), the thread's minimum over its slots (2 levels of
# compare and select: 16; K = 10 has 4, +16), the order-preserving key
# (12), two redux.sync with a select between (68), the warp's pair to
# shared memory and the barrier (40), its read back (30), two redux.sync
# (68) and the decode of the next column and row (4): 523, taken as 520;
# a walk-back step as the slots route's.
K2_COLUMNS_CHAIN_CYCLES = {"dijkstra": 520, "augmentation": 100}
K3_FIRST_SEED = 11  # K3's cases take seeds from here on, bf16 first
# K3 at the shapes the new main paths give it: (label, BH, Tq, Tk, D)
K3_SHAPES = (("1280 encoder", 64, 1600, 1600, 32),
             ("1280 cross-attention", 64, 96, 1600, 32),
             ("decoder self-attention", 64, 96, 96, 32),
             ("ViT-p16 blocks", 48, 1600, 1600, 64),
             ("ViT config's DETR encoder", 64, 400, 400, 32),
             ("ViT config's DETR cross-attention", 64, 96, 400, 32),
             ("ragged", 16, 300, 520, 64),
             # encoder_dim=384 over 8 heads: D = 48, padded with zeros to 64
             ("D=48 (encoder_dim 384, 8 heads) at 640", 64, 400, 400, 48),
             # vit_h16's blocks: 16 heads of D = 80 (ViT-Huge's widths),
             # as built (the TPU pads it to 128); bf16 dq and dk/dv on the
             # wgmma kernels, as at D = 128
             ("ViT-H blocks", 128, 1600, 1600, 80),
             # vit_w512_h4 at batch 8: D = 128 as built
             ("vit_w512_h4 blocks", 32, 1600, 1600, 128),
             # past 128, the wide kernels: vit_l16_h4's blocks (4 heads of
             # D = 256 at batch 8), D = 160 padded with zeros to 256, and
             # D = 384
             ("ViT-L blocks at 4 heads", 32, 1600, 1600, 256),
             ("D=160 padded to 256", 16, 400, 400, 160),
             ("D=384", 8, 400, 400, 384),
             # past 384 the bf16 dq and dk/dv take the chunked kernels
             ("D=512, the chunked route", 4, 400, 400, 512))


def _say(*parts):
    print(*parts, flush=True)


def _close(out, ref, atol, rtol, what):
    """Holds ``out`` to ``ref`` elementwise within ``atol + rtol * |ref|``.
    The comparison runs on the host, on float32 copies of both, so that no
    verdict rests on a reduction computed by the card under test."""
    if out.shape != ref.shape:
        raise AssertionError(f"{what}: shape {tuple(out.shape)} against "
                             f"{tuple(ref.shape)}")
    out = out.detach().float().cpu()
    ref = ref.detach().float().cpu()
    err = (out - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-6)).max().item()
    bad = (err > atol + rtol * ref.abs()).sum().item()
    _say(f"  {what}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
         f"(atol {atol:g}, rtol {rtol:g}); {bad} of {out.numel()} values "
         "outside")
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f"{what}: {bad} of {out.numel()} values outside "
                             "the tolerance")
    return max_abs


def _norm_rel(out, ref):
    """||out - ref|| / ||ref||, both L2 over all values, in float64."""
    out, ref = out.double(), ref.double()
    return ((out - ref).norm() / ref.norm()).item()


def _time_ms(fn, flush, repeats=REPEATS, spin_cycles=0):
    """Median of ``repeats`` launches timed one by one with CUDA events,
    each after a write of a buffer larger than the 50 MB L2, so that every
    launch finds its inputs in device memory as a fresh request would. The
    card is idle when ``fn`` starts, so the time holds the host's way
    through the wrapper to the launch. With ``spin_cycles`` the card first
    spins that many of its clock cycles, during which the host gets to the
    launch: the events then bracket the card's time alone."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(repeats):
        flush.zero_()
        if spin_cycles:
            torch.cuda._sleep(spin_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_kernels(fn, tag):
    """Names of the device kernels with ``tag`` in their name that one call
    of ``fn`` runs, from a profile."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and tag in e.key]


def _expect_kernel(fn, tag, name, what):
    """Raises unless the one kernel with ``tag`` that ``fn`` runs is
    ``name`` (a profile that recorded nothing is taken again, twice)."""
    fn()  # built and loaded before the profile
    for _ in range(3):
        ran = _device_kernels(fn, tag)
        if ran:
            break
    # a template's name is followed by its arguments, a plain one's by (
    if len(ran) != 1 or not any(f"{name}{c}" in ran[0] for c in "<("):
        raise AssertionError(f"{what}: expected {name}, ran {ran}")
    _say(f"  {what}: ran {name}")


def kernel_names() -> int:
    """``chip_smoke.py kernel-names``, which the main run starts as a process
    of its own once its timed phases are over: which device kernel each
    forward of the kernels phase runs, by name from a profile: the
    tensor-core kernels for bf16, the CUDA-core ones for float32 and for
    the P=4 stem; the same for each weight gradient; in bf16 the route
    of the forward, dq and dk/dv (mma.sync or wgmma up to D = 128,
    resident or chunked past it), in float32 past 128 the route of dq and
    dk/dv (the TF32 kernels at a padded 256, the CUDA-core ones past it),
    and the wgmma, wide and TF32 kernels' blocks an SM (``occupancy``).
    Apart, because a
    profiler, once used, stays attached to its process, slows every later
    launch there, and after the paths' long profiles drops kernels of
    short ones. K2's cases too: the slots or columns kernel, and its
    slots, that each shape launches."""
    from boosted_detr_torch.ops import attention as A
    from boosted_detr_torch.ops import build
    from boosted_detr_torch.ops import lap as L
    from boosted_detr_torch.ops import patchify as P

    for patch, c_out, dtype, seed, res in K1_CASES:
        x, w = _patchify_inputs(patch, c_out, dtype, seed, res)
        plan = P.tensor_core_plan(tuple(x.shape), tuple(w.shape), w.dtype)
        _expect_kernel(lambda: P.patchify_conv(x, w, clip01=True),
                       "patchify_fwd", "patchify_fwd_kernel" if plan is None
                       else "patchify_fwd_mma_kernel",
                       _patchify_label(patch, c_out, dtype, res))
    for patch, c_out, dtype, seed, res in DW_CASES:
        x, g = _dw_inputs(patch, c_out, dtype, seed, res)
        plan = P.dw_tensor_core_plan(tuple(x.shape), tuple(g.shape), patch,
                                     dtype)
        _expect_kernel(lambda: P.patchify_conv_dw(x, g, patch, dtype,
                                                  clip01=True),
                       "patchify_dw", "patchify_dw_partial_kernel"
                       if plan is None else "patchify_dw_mma_kernel",
                       _dw_label(patch, c_out, dtype, res))
    seed = K3_FIRST_SEED
    for dtype in (torch.bfloat16, torch.float32):
        for label, bh, tq, tk, d in K3_SHAPES:
            q, k, v = _attention_inputs(bh, tq, tk, d, dtype, seed)[:3]
            seed += 1
            if d > A.CHUNK:
                # which backend the SDPA yardstick of the kernels phase
                # takes past 128 (flash attention takes D <= 256)
                q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
                sdpa = torch.nn.functional.scaled_dot_product_attention
                sdpa(q4, k4, v4)
                ran = _device_kernels(lambda: sdpa(q4, k4, v4), "")
                _say(f"  {_attention_label(label, bh, tq, tk, d, dtype)} "
                     f"SDPA yardstick ran: {[n[:70] for n in ran]}")
            wide = "wide_" if A.padded_head_dim(d) > A.CHUNK else ""
            what = _attention_label(label, bh, tq, tk, d, dtype)
            # the bf16 forward's route: mma.sync or wgmma up to 128, past
            # it resident or chunked
            _expect_kernel(lambda: A.attention_fwd(q, k, v), "attn_fwd",
                           f"attn_fwd_{wide}kernel"
                           if dtype != torch.bfloat16
                           else A.wide_forward_kernel(d) if wide
                           else A.narrow_forward_kernel(d), what)
            if dtype == torch.bfloat16 or wide:
                # the gradients' route: up to 128 wgmma but mma.sync over
                # short streams (dq at D = 32, dk/dv at D <= 64), past it
                # resident or chunked; float32 past 128 the TF32 kernels at
                # a padded 256, else the CUDA-core ones
                g = torch.randn_like(q)
                out, lse = A.attention_fwd_reference(q, k, v)
                args = (q, k, v, g, lse, (g.float() * out.float()).sum(-1))
                names = (A.wide_gradient_kernels(d, dtype) if wide
                         else A.narrow_gradient_kernels(d, tq, tk))
                _expect_kernel(lambda: A.attention_dq(*args), "attn_dq",
                               names[0], f"{what} dq")
                _expect_kernel(lambda: A.attention_dkdv(*args), "attn_dkdv",
                               names[1], f"{what} dk/dv")
    for b, o, p, seed, edges in K2_CASES:
        cost_np, n_np = _lap_inputs(b, o, p, seed, edges)
        cost, n = (torch.from_numpy(a).cuda() for a in (cost_np, n_np))
        _expect_kernel(lambda: L.hungarian_lap(cost, n), "lap_",
                       L.kernel_name(o, p), f"LAP [{b}, {o}, {p}]")
    k3 = ptxas_k3(build.build("attention").with_suffix(".log").read_text())
    _say("  K3 wgmma and wide bf16 kernels: " + json.dumps(occupancy(k3)))
    return 0


def phase_kernel_names():
    _say("[kernel names] the device kernel of each forward of the kernels "
         "phase, from a profile in a process of its own")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "kernel-names"],
        capture_output=True, text=True, check=False, timeout=600)
    _say(proc.stdout.rstrip())
    if proc.returncode != 0:
        raise AssertionError(f"kernel-names failed:\n{proc.stderr[-3000:]}")


def ptxas_k3(log):
    """ptxas -v's report of each K3 instantiation in a build log,
    {"attn_<kind>_kernel D=<D>": {"registers", "spill_stores",
    "spill_loads"}}: D is the mma kernels' template argument, the float32
    kernels' dims a thread times threads a row, the resident wide kernels'
    (attn_<kind>_wide_mma_kernel<NC>, the forward's too) 128 times theirs
    (the chunks); the chunked wide kernels (no template) read
    "D=128n", the float32 TF32 ones (``attn_*_wide_tf32_kernel``, no
    template) "D=256"."""
    rows, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '\S*?\d(attn_\w+?_kernel)"
                          r"I((?:Li\d+E)+)E", line)
        wide = re.search(r"Compiling entry function '\S*?\d"
                         r"(attn_\w+?_wide_\w*?kernel)E", line)
        if entry:
            d = int(np.prod([int(n) for n in
                             re.findall(r"Li(\d+)E", entry.group(2))]))
            if "_wide_" in entry.group(1):
                d *= 128
            name = f"{entry.group(1)} D={d}"
            continue
        if wide:
            tf32 = "_tf32_" in wide.group(1)
            name = f"{wide.group(1)} D={256 if tf32 else '128n'}"
            continue
        if "Compiling entry" in line:
            name = None
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        used = re.search(r"Used (\d+) registers", line)
        if name and spill:
            rows.setdefault(name, {}).update(spill_stores=int(spill.group(1)),
                                             spill_loads=int(spill.group(2)))
        if name and used:
            rows.setdefault(name, {})["registers"] = int(used.group(1))
    return dict(sorted(rows.items()))


def phase_build():
    """Builds every kernel source at once and prints ptxas's registers and
    spills; returns K3's, one row per instantiation (``ptxas_k3``)."""
    from boosted_detr_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_all()
    _say(f"[build] {len(libs)} kernel source(s) in "
         f"{time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text()
        notes = {}  # ptxas's C75xx notes by code (C7515: wgmmas serialised)
        for line in log.splitlines():
            note = re.search(r"\((C75\d\d)\)", line)
            if note:
                notes[note[1]] = notes.get(note[1], 0) + 1
            elif ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                _say(f"  {name}: {line.strip()}")
        if notes:
            _say(f"  {name}: ptxas notes by code: {notes}")
    k3 = ptxas_k3(libs["attention"].with_suffix(".log").read_text())
    _say("[build] ptxas K3 (registers, spill bytes stored and loaded): "
         + json.dumps(k3))
    if len(k3) != 41:
        raise AssertionError(f"expected 41 K3 kernels (3 kernels, 2 dtypes, "
                             f"D = 32, 64, 80, 128, in bf16 the forward, "
                             f"dq and dk/dv on wgmma at all four, dq on "
                             f"mma.sync at 32 and dk/dv at 32 and 64, the "
                             f"6 chunked wide ones, the resident "
                             f"forward, dq and dk/dv at D = 256 and 384, "
                             f"and the float32 TF32 dq and dk/dv at "
                             f"D = 256), read {len(k3)}")
    _say("[build] K3 wgmma and wide bf16 kernels: "
         + json.dumps(occupancy(k3)))
    return k3


def occupancy(k3):
    """{"<kernel> D=<D>": {"blocks_per_sm", "smem_bytes", "registers",
    "spill_bytes"}} of K3's kernels that TMA feeds: the bf16 wgmma forward
    (in the blocks it launches: one warpgroup at D <= 64, two at 80 and
    128), dq and dk/dv at D = 32, 64, 80 and 128,
    and the wide forward, dq and dk/dv on the route a launch at D = 256,
    384 and 512 takes (resident, then chunked: the design whose shared
    memory and threads do not depend on D), and the float32 TF32 dq and
    dk/dv at D = 256; blocks an SM from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at the kernel's
    shared memory (``kernel_occupancy``), registers and spill bytes from
    ptxas (``ptxas_k3``)."""
    from boosted_detr_torch.ops import attention as A

    cases = ([(kind, d) for d in (32, 64, 80, 128)
              for kind in ("fwd", "dq", "dkdv")]
             + [(kind, d) for kind in ("fwd", "dq", "dkdv")
                for d in (256, 384, 512)])
    out = {}
    for kind, d in cases:
        if d > A.CHUNK:
            names = (A.wide_forward_kernel(d), *A.wide_gradient_kernels(d))
        else:  # the wgmma route: each kernel's over long streams
            long = A.SHORT_STREAM + 1
            names = (A.narrow_forward_kernel(d),
                     *A.narrow_gradient_kernels(d, long, long))
        name = names[("fwd", "dq", "dkdv").index(kind)]
        blocks, smem = A.kernel_occupancy(kind, d)
        if blocks < 1:
            raise AssertionError(f"{name} at D = {d}: no block fits an SM")
        key = "D=128n" if "chunked" in name else f"D={d}"
        report = k3.get(f"{name} {key}", {})
        out[f"{name} D={d}"] = {
            "blocks_per_sm": blocks, "smem_bytes": smem,
            "registers": report.get("registers"),
            "spill_bytes": report.get("spill_stores", 0)
            + report.get("spill_loads", 0)}
    # the float32 dq and dk/dv on the tensor cores (three TF32 products)
    for kind, name in zip(("dq", "dkdv"), A.wide_gradient_kernels(
            A.TF32_HEAD_DIM, torch.float32)):
        blocks, smem = A.kernel_occupancy(kind, A.TF32_HEAD_DIM,
                                          torch.float32)
        if blocks < 1:
            raise AssertionError(f"{name}: no block fits an SM")
        report = k3.get(f"{name} D={A.TF32_HEAD_DIM}", {})
        out[f"{name} D={A.TF32_HEAD_DIM}"] = {
            "blocks_per_sm": blocks, "smem_bytes": smem,
            "registers": report.get("registers"),
            "spill_bytes": report.get("spill_stores", 0)
            + report.get("spill_loads", 0)}
    return out


def _sides(res):
    """(height, width) of a case's resolution: a side, or both."""
    return tuple(res) if isinstance(res, tuple) else (res, res)


def _patchify_inputs(patch, c_out, dtype, seed, res):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((BATCH, *_sides(res), 3), generator=gen, device="cuda")
    x = x * 1.2 - 0.1  # a little outside [0, 1], so that the clip works
    k = patch * patch * 3
    w = (torch.randn((patch, patch, 3, c_out), generator=gen, device="cuda")
         * (2.0 / k ** 0.5)).to(dtype)
    return x, w


def _res_label(res):
    h, w = _sides(res)
    return f"{h}px" if h == w else f"{h}x{w}px"


def _patchify_label(patch, c_out, dtype, res):
    return f"{_res_label(res)} P={patch} -> {c_out} {str(dtype)[6:]}"


def _patchify_case(patch, c_out, dtype, seed, res, flush):
    from boosted_detr_torch.ops import patchify as P

    x, w = _patchify_inputs(patch, c_out, dtype, seed, res)
    k = patch * patch * 3
    out = P.patchify_conv(x, w, clip01=True)
    ref = P.patchify_conv_reference(x, w, clip01=True)
    torch.cuda.synchronize()
    what = _patchify_label(patch, c_out, dtype, res)
    # float32: only the order of the float32 sums differs. bfloat16: both
    # round identical inputs and sum in float32, so the outputs differ by
    # at most one rounding of the bf16 result, 2**-7 relative.
    tol = (dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32
           else dict(atol=1e-5, rtol=2.0 ** -7))
    max_abs = _close(out, ref, what=what, **tol)
    row = {"shape": what, "max_abs_err": max_abs}
    if P.tensor_core_plan(tuple(x.shape), tuple(w.shape), w.dtype) is None:
        # the CUDA-core kernel's cut of a row: channels and positions a block
        row["cut"] = P.fwd_span_plan(patch, 3, out.shape[2], c_out,
                                     w.dtype == torch.bfloat16)._asdict()
        _say(f"  {what}: CUDA-core kernel, {row['cut']}")
    m = out.numel() // c_out
    n_bytes = (x.numel() * 4 + w.numel() * w.element_size()
               + out.numel() * out.element_size())
    ops = 2 * m * k * c_out
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    row.update(bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    # The library yardstick, which the port never calls: cuDNN's stride-P
    # conv of the clipped image in the weights' dtype (NCHW views of NHWC
    # data, channels_last). Its error is shown, not held to a tolerance.
    # ``library_ms`` times the conv alone, on an image clipped and converted
    # beforehand (half the kernel's bytes in bf16), as in every earlier run;
    # ``library_full_ms`` times what the kernel computes: clamp, convert
    # and conv.
    def clipped():
        return x.clamp(0.0, 1.0).to(dtype).permute(0, 3, 1, 2)

    xc = clipped()
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib = torch.nn.functional.conv2d(xc, wc, stride=patch)
    lib_err = (lib.permute(0, 2, 3, 1).float() - ref.float()).abs().max()
    _say(f"  {what} cuDNN yardstick: max abs err {lib_err.item():.3e}")
    row.update(
        ms=_time_ms(lambda: P.patchify_conv(x, w, clip01=True), flush),
        plain_ms=_time_ms(
            lambda: P.patchify_conv_reference(x, w, clip01=True), flush),
        library_ms=_time_ms(
            lambda: torch.nn.functional.conv2d(xc, wc, stride=patch), flush),
        library_full_ms=_time_ms(
            lambda: torch.nn.functional.conv2d(clipped(), wc, stride=patch),
            flush),
        device_ms=_time_ms(lambda: P.patchify_conv(x, w, clip01=True), flush,
                           spin_cycles=SPIN_CYCLES))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    _say(f"  {what}: kernel {row['ms']:.4f} ms, plain "
         f"{row['plain_ms']:.4f} ms, cuDNN {row['library_ms']:.4f} ms (with "
         f"the clamp and the conversion {row['library_full_ms']:.4f} ms), "
         f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
         f"{100 * row['bound_share']:.1f}% of it reached); "
         f"{row['device_ms']:.4f} ms with the launch enqueued ahead of the "
         f"card")
    return row


@functools.cache
def _ex2_per_s():
    """ex2 a second on every SM of card 0 at its top SM clock (nvidia-smi's
    ``clocks.max.sm``): the floor the exponentials set, below the clock a
    card holds under load."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EX2_PER_CLOCK_PER_SM * sms * mhz * 1e6


def _bound(n_bytes, ops, dtype, rate=None):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / (rate or PEAK_OPS_PER_S[dtype]) * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _dw_inputs(patch, c_out, dtype, seed, res):
    """The image and an output cotangent g in the weights' dtype (the
    output's, on the stem), as the train step gives them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h, w = _sides(res)
    x = torch.rand((BATCH, h, w, 3), generator=gen, device="cuda")
    x = x * 1.2 - 0.1
    g = torch.randn((BATCH, h // patch, w // patch, c_out), generator=gen,
                    device="cuda").to(dtype)
    return x, g


def _dw_label(patch, c_out, dtype, res):
    return f"dW {_res_label(res)} P={patch} -> {c_out} {str(dtype)[6:]}"


def _dw_case(patch, c_out, dtype, seed, res, flush):
    """K1-dW: the stem's weight gradient at one of DW_CASES."""
    from boosted_detr_torch.ops import patchify as P

    x, g = _dw_inputs(patch, c_out, dtype, seed, res)
    dw, dw32 = P.patchify_conv_dw(x, g, patch, dtype, clip01=True)
    ref, ref32 = P.patchify_conv_dw_reference(x, g, patch, dtype,
                                              clip01=True)
    torch.cuda.synchronize()
    what = _dw_label(patch, c_out, dtype, res)
    # Both sum the same exact products of rounded values in float32, in
    # other orders (the kernel's per-chunk partials against cuBLAS): the
    # float32 sums differ by a few ulps of the sum of the products'
    # magnitudes, held to 1e-5 of it. The cast results then differ by at
    # most one bf16 ulp where the sums straddle a rounding boundary: 2**-7.
    patches, _ = P._patch_matrix(x, patch, dtype, True)
    scale = (patches.float().abs().t()
             @ g.reshape(-1, c_out).float().abs()).reshape(dw32.shape)
    bound32 = 1e-5 * scale + 1e-6
    bad = ((dw32 - ref32).abs() > bound32).sum().item()
    err = (dw.float() - ref.float()).abs()
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    bad += (err > bound32 + ulp * ref.float().abs()).sum().item()
    max_abs = err.max().item()
    _say(f"  {what}: max abs err {max_abs:.3e} (float32 sums "
         f"{(dw32 - ref32).abs().max().item():.3e}; held to 1e-5 of the "
         f"summed |products| plus one result ulp); {bad} values outside")
    if bad or not torch.isfinite(dw32).all():
        raise AssertionError(f"{what}: {bad} values outside the tolerance")
    m, k = patches.shape
    row = {"shape": what, "max_abs_err": max_abs}
    if P.dw_tensor_core_plan(tuple(x.shape), tuple(g.shape), patch,
                             dtype) is None:
        row["cut"] = P.dw_span_plan(patch, 3, g.shape[2])._asdict()
        _say(f"  {what}: CUDA-core kernel, {row['cut']}")
    row.update(_bound(x.numel() * 4 + g.numel() * g.element_size()
                      + dw.numel() * (dw.element_size() + 4),
                      2 * m * k * c_out, dtype))
    # The library yardstick, which the port never calls: cuDNN's weight
    # gradient of the stride-P conv on the clipped image in the weights'
    # dtype (NCHW views of NHWC data, channels_last). ``library_ms`` times
    # it on an image clipped and converted beforehand, as in every earlier
    # run; ``library_full_ms`` times what the kernel computes: clamp,
    # convert and the weight gradient.
    def clipped():
        return x.clamp(0.0, 1.0).to(dtype).permute(0, 3, 1, 2)

    xc = clipped()
    gc = g.permute(0, 3, 1, 2)
    w_size = (c_out, 3, patch, patch)
    lib = torch.nn.grad.conv2d_weight(xc, w_size, gc, stride=patch)
    lib_err = (lib.permute(2, 3, 1, 0).float() - ref32).abs().max().item()
    _say(f"  {what} cuDNN yardstick: max abs err {lib_err:.3e}")

    def kernel():
        return P.patchify_conv_dw(x, g, patch, dtype, clip01=True)

    row.update(
        ms=_time_ms(kernel, flush),
        plain_ms=_time_ms(lambda: P.patchify_conv_dw_reference(
            x, g, patch, dtype, clip01=True), flush),
        library_ms=_time_ms(lambda: torch.nn.grad.conv2d_weight(
            xc, w_size, gc, stride=patch), flush),
        library_full_ms=_time_ms(lambda: torch.nn.grad.conv2d_weight(
            clipped(), w_size, gc, stride=patch), flush),
        device_ms=_time_ms(kernel, flush, spin_cycles=SPIN_CYCLES))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    _say(f"  {what}: kernel {row['ms']:.4f} ms, plain "
         f"{row['plain_ms']:.4f} ms, cuDNN {row['library_ms']:.4f} ms (with "
         f"the clamp and the conversion {row['library_full_ms']:.4f} ms), "
         f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
         f"{100 * row['bound_share']:.1f}% of it reached); "
         f"{row['device_ms']:.4f} ms with the launch enqueued ahead of the "
         f"card ({100 * row['bound_ms'] / row['device_ms']:.1f}% of the "
         f"bound)")
    return row


def _lap_inputs(b, o, p, seed, edges=False):
    """K2's inputs as numpy arrays: tie-free random costs [b, o, p] and
    object counts [b] from 1 to o (with ``edges``: 0 in the first problem
    and o in the last)."""
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0.0, 10.0, (b, o, p)).astype(np.float32)
    n = rng.integers(1, o + 1, (b,)).astype(np.int32)
    if edges:  # no objects, and every row taking part
        n[0], n[-1] = 0, o
    return cost, n


def _lap_case(b, o, p, seed, flush, edges):
    """K2 on tie-free random costs: valid masks at scipy's total cost, and
    the plain version's mask (the same float32 arithmetic, step for
    step)."""
    from scipy.optimize import linear_sum_assignment

    from boosted_detr_torch.ops import lap as L

    cost_np, n_np = _lap_inputs(b, o, p, seed, edges)
    cost = torch.from_numpy(cost_np).cuda()
    n = torch.from_numpy(n_np).cuda()
    got = L.hungarian_lap(cost, n)
    L.hungarian_lap_reference.relaxations = 0
    want = L.hungarian_lap_reference(cost, n)
    relaxations = L.hungarian_lap_reference.relaxations
    # the Dijkstra and walk-back steps of each problem alone: the kernel
    # gives a problem one warp, so the longest problem's chain of steps
    # bounds its time
    steps = []
    for i in range(b):
        L.hungarian_lap_reference.relaxations = 0
        L.hungarian_lap_reference.augmentation_steps = 0
        L.hungarian_lap_reference(cost[i:i + 1], n[i:i + 1])
        steps.append((L.hungarian_lap_reference.relaxations,
                      L.hungarian_lap_reference.augmentation_steps))
    torch.cuda.synchronize()

    kernel = L.kernel_name(o, p)
    chain = (K2_CHAIN_CYCLES if L.kernel_plan(o, p).route == "slots"
             else K2_COLUMNS_CHAIN_CYCLES)

    def chain_cycles(counts):
        return (chain["dijkstra"] * counts[0]
                + chain["augmentation"] * counts[1])

    longest = max(steps, key=chain_cycles)
    what = f"LAP [{b}, {o}, {p}]" + (" n=0 and n=O" if edges else "")
    mask = got.cpu().numpy()
    for i in range(b):
        ni = int(n_np[i])
        ok = (mask[i, ni:] == 0).all() and (mask[i].sum(0) <= 1).all()
        if ni:
            r, c = linear_sum_assignment(cost_np[i, :ni])
            ok = ok and (mask[i, :ni].sum(1) == 1).all() and np.isclose(
                (mask[i] * cost_np[i]).sum(), cost_np[i][r, c].sum(),
                rtol=1e-5, atol=1e-3)
        if not ok:
            raise AssertionError(f"{what}: problem {i} is not an optimal "
                                 f"assignment")
    max_abs = (got - want).abs().max().item()
    _say(f"  {what}: valid, at scipy's total cost (rtol 1e-5, atol 1e-3); "
         f"max abs err against the plain version {max_abs:.1f} (tie-free "
         f"costs: held to 0)")
    if max_abs != 0.0:
        raise AssertionError(f"{what}: the kernel's mask is not the plain "
                             f"version's")
    # Bytes: cost and num_objects in, mask out. Operations: what this data
    # took, 6 float32 operations per column in each Dijkstra step (two
    # subtractions and a compare for the relaxation, a compare for the
    # argmin, the dual or distance update).
    row = {"shape": what, "kernel": kernel, "max_abs_err": max_abs,
           "relaxations": relaxations,
           "longest_steps": max(s[0] for s in steps),
           "longest_augmentation_steps": longest[1],
           "chain_ms": chain_cycles(longest) / K2_CHAIN_HZ * 1e3}
    row.update(_bound(2 * cost.numel() * 4 + n.numel() * 4,
                      relaxations * (p + o + 1) * 6, torch.float32))

    def host():
        costs = cost.cpu().numpy()
        for i in range(b):
            if n_np[i]:
                linear_sum_assignment(costs[i, :n_np[i]])

    row.update(ms=_time_ms(lambda: L.hungarian_lap(cost, n), flush),
               plain_ms=_time_ms(lambda: L.hungarian_lap_reference(cost, n),
                                 flush, repeats=5),
               library_ms=None, scipy_host_ms=_host_ms(host),
               device_ms=_time_ms(lambda: L.hungarian_lap(cost, n), flush,
                                  spin_cycles=SPIN_CYCLES))
    row["chain_share"] = row["chain_ms"] / row["device_ms"]
    _say(f"  {what}: {kernel} {row['ms']:.4f} ms ({row['device_ms']:.4f} "
         f"ms with the launch enqueued ahead of the card), plain "
         f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.6f} ms "
         f"({row['bound_by']}, {relaxations} Dijkstra steps, the longest "
         f"problem {row['longest_steps']}); serial-chain yardstick "
         f"{row['chain_ms']:.4f} ms ({longest[0]} Dijkstra and {longest[1]} "
         f"walk-back steps at {chain['dijkstra']} and "
         f"{chain['augmentation']} cycles; {100 * row['chain_share']:.1f}% "
         f"of the card "
         f"time); no PyTorch call computes a LAP; note: scipy on the host, "
         f"D2H copy included, {row['scipy_host_ms']:.4f} ms")
    return row


def _attention_inputs(bh, tq, tk, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, g = (torch.randn((bh, t, d), generator=gen, device="cuda")
                  .to(dtype) for t in (tq, tk, tk, tq))
    g_lse = torch.randn((bh, tq), generator=gen, device="cuda")
    return q, k, v, g, g_lse


def _attention_label(label, bh, tq, tk, d, dtype):
    return f"K3 {label} [{bh}, {tq}, {tk}, {d}] {str(dtype)[6:]}"


def _sdpa_errors(q, k, v, g, ref, ref_lse):
    """SDPA's largest differences from the plain versions on [1, BH, T, D]
    views: its out, and dq, dk and dv of the cotangent ``g`` of out alone
    (SDPA has no lse to take one of), so that its float32 route is known to
    be float32-accurate where it is the yardstick."""
    import torch.nn.functional as F

    from boosted_detr_torch.ops import attention as A

    q4, k4, v4 = (t.detach().unsqueeze(0).requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4)
    grads = torch.autograd.grad(out, (q4, k4, v4), g.unsqueeze(0))
    args = (q, k, v, g, ref_lse, (g.float() * ref.float()).sum(-1))
    want = (A.attention_dq_reference(*args),
            *A.attention_dkdv_reference(*args))
    errs = {"out": (out[0].detach() - ref).abs().max().item()}
    errs.update({name: (a[0] - b).abs().max().item()
                 for name, a, b in zip(("dq", "dk", "dv"), grads, want)})
    return errs


def _attention_case(label, bh, tq, tk, d, dtype, seed, flush, ptxas=None):
    """K3-fwd (with the lse), K3-dq and K3-dkdv at one shape against their
    plain versions; in bf16 (and float32 at D > 64) also timed, with
    F.scaled_dot_product_attention (forward, and forward + backward) as
    the library yardstick, which the port never calls, and the backward
    alone beside it. In bf16 up to D = 128 the rows of the forward, dq
    and dk/dv also name their kernels (wgmma, but mma.sync over short
    streams for dq at D = 32 and dk/dv at D <= 64)
    with ptxas's registers and spills (from ``ptxas``, ``ptxas_k3``'s
    rows), each is launched a second time and held to the
    first bit for bit, and each is held against its emulation
    (``attention_fwd_emulation``, ``attention_dq_emulation``,
    ``attention_dkdv_emulation``: one bf16 ulp, at least 99% of the values
    equal; the lse within 1e-5). In float32 at a padded D = 256 (the TF32
    dq and dk/dv) the gradients' rows do the same: their kernels by name,
    ptxas's report and blocks an SM, a second launch, and the emulation
    (``TF32_EMULATION_GATE``), their ``bound_ms`` that of three TF32
    products a product on the tensor cores, with the CUDA-core one
    (``bound_cuda_core_ms``) beside it; every float32 row prints
    SDPA's own differences from the plain versions. Returns one row per
    kernel."""
    import torch.nn.functional as F

    from boosted_detr_torch.ops import attention as A

    q, k, v, g, g_lse = _attention_inputs(bh, tq, tk, d, dtype, seed)
    out, lse = A.attention_fwd(q, k, v)
    ref, ref_lse = A.attention_fwd_reference(q, k, v)
    # both backward kernels get the plain forward's lse and delta, so that
    # each is held against its own plain version alone
    delta = (g.float() * ref.float()).sum(-1) - g_lse
    args = (q, k, v, g, ref_lse, delta)
    dq = A.attention_dq(*args)
    dk, dv = A.attention_dkdv(*args)
    ref_dq = A.attention_dq_reference(*args)
    ref_dk, ref_dv = A.attention_dkdv_reference(*args)
    torch.cuda.synchronize()
    what = _attention_label(label, bh, tq, tk, d, dtype)
    # float32: the same float32 formulas summed in other orders (64-row
    # tiles and 4-16-row chunks against cuBLAS): out 1e-5 / 1e-4, the
    # gradients (sums over up to 1600 rows) 1e-4 / 1e-4. bfloat16: the K1
    # gates, one rounding of the result (2**-7) over 1e-5, and 1e-4 for the
    # gradients' float32 sums (the tensor-core kernels carry p and ds as
    # bf16 hi + lo to stay inside both). The lse is float32 in both: 1e-5 /
    # 1e-5.
    if dtype == torch.float32:
        tol, grad_tol = dict(atol=1e-5, rtol=1e-4), dict(atol=1e-4, rtol=1e-4)
    else:
        tol = dict(atol=1e-5, rtol=2.0 ** -7)
        grad_tol = dict(atol=1e-4, rtol=2.0 ** -7)
    errs = {"fwd": max(_close(out, ref, what=f"{what} out", **tol),
                       _close(lse, ref_lse, atol=1e-5, rtol=1e-5,
                              what=f"{what} lse")),
            "dq": _close(dq, ref_dq, what=f"{what} dq", **grad_tol),
            "dkdv": max(_close(dk, ref_dk, what=f"{what} dk", **grad_tol),
                        _close(dv, ref_dv, what=f"{what} dv", **grad_tol))}
    size = q.element_size()
    pairs = bh * tq * tk * d
    nq, nk = bh * tq * d, bh * tk * d  # a q-shaped and a k-shaped tensor
    n_bytes = {  # each input read once, each output written once
        "fwd": size * (2 * nq + 2 * nk) + 4 * bh * tq,  # q k v, out, lse
        "dq": size * (3 * nq + 2 * nk) + 8 * bh * tq,  # + g, lse, delta
        "dkdv": size * (2 * nq + 4 * nk) + 8 * bh * tq}
    ops = {"fwd": 4 * pairs, "dq": 6 * pairs, "dkdv": 8 * pairs}
    rows = {}
    for name in ("fwd", "dq", "dkdv"):
        rows[name] = {"shape": what, "max_abs_err": errs[name],
                      "library_ms": None}
        rows[name].update(_bound(n_bytes[name], ops[name], dtype))
        if dtype == torch.bfloat16:  # one ex2 a query-key pair for p
            rows[name]["ex2_floor_ms"] = bh * tq * tk / _ex2_per_s() * 1e3
    padded = A.padded_head_dim(d)
    if dtype == torch.float32:
        sdpa = _sdpa_errors(q, k, v, g, ref, ref_lse)
        _say(f"  {what} SDPA float32 against the plain versions: max abs "
             "err " + ", ".join(f"{n} {e:.3e}" for n, e in sdpa.items()))
        for name in rows:
            rows[name]["sdpa_max_abs_err"] = sdpa
    if dtype == torch.float32 and padded == A.TF32_HEAD_DIM:
        # dq and dk/dv on the tensor cores, three TF32 products a product:
        # a second launch, the same bits; against the emulation of their
        # arithmetic
        again = (A.attention_dq(*args), *A.attention_dkdv(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))):
            raise AssertionError(f"{what}: a second launch of dq or dk/dv "
                                 "gave other bits")
        padded_args = (*A._padded(q, k, v, g), ref_lse, delta)
        emulated = (A.attention_dq_emulation(*padded_args, scale=A._scale(d)),
                    *A.attention_dkdv_emulation(*padded_args,
                                                scale=A._scale(d)))
        off = {}
        for part, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                   emulated):
            want = want[..., :d]
            big = want.abs().max().item()
            _close(got, want, atol=TF32_EMULATION_GATE * big, rtol=0.0,
                   what=f"{what} {part} against the emulation")
            off[part] = (got - want).abs().max().item() / big
        _say(f"  {what} dq, dk, dv off the emulation by "
             f"{json.dumps(off)} of their largest values")
        rows["dq"]["off_emulation"] = off["dq"]
        rows["dkdv"]["off_emulation"] = max(off["dk"], off["dv"])
        for name, kernel in zip(("dq", "dkdv"),
                                A.wide_gradient_kernels(d, dtype)):
            report = (ptxas or {}).get(f"{kernel} D={padded}", {})
            blocks, smem = A.kernel_occupancy(name, padded, dtype)
            # the bound of the work they do: three TF32 products a
            # product on the tensor cores; beside it the same function on
            # the CUDA cores, and its own products at the TF32 rate
            rows[name].update(
                kernel=kernel, repeats_bit_for_bit=True,
                registers=report.get("registers"),
                spill_bytes=report.get("spill_stores", 0)
                + report.get("spill_loads", 0), blocks_per_sm=blocks,
                smem_bytes=smem,
                bound_cuda_core_ms=rows[name]["bound_ms"],
                bound_one_tf32_ms=ops[name] / TF32_OPS_PER_S * 1e3,
                **_bound(n_bytes[name], 3 * ops[name], dtype,
                         TF32_OPS_PER_S))
            _say(f"  {what} {name}: {kernel}, {rows[name]['registers']} "
                 f"registers, {rows[name]['spill_bytes']} spill bytes, "
                 f"{blocks} block(s) an SM at {smem} bytes of shared "
                 "memory; a second launch gave the same bits")
    if dtype == torch.bfloat16 and padded <= A.CHUNK:
        # the kernels up to D = 128 (wgmma, mma.sync as named above):
        # their names, ptxas's report, and a second launch of each, the
        # same bits (no atomics, sums in a fixed order); each against the
        # emulation of its arithmetic
        again = (*A.attention_fwd(q, k, v), A.attention_dq(*args),
                 *A.attention_dkdv(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b)
                   for a, b in zip(again, (out, lse, dq, dk, dv))):
            raise AssertionError(f"{what}: a second launch of the forward, "
                                 "dq or dk/dv gave other bits")
        emu, emu_lse = A.attention_fwd_emulation(*A._padded(q, k, v),
                                                 scale=A._scale(d))
        emu = emu[..., :d]
        _close(out, emu, atol=1e-5 * emu.float().abs().max().item(),
               rtol=2.0 ** -7, what=f"{what} out against the emulation")
        _close(lse, emu_lse, atol=1e-5, rtol=1e-5,
               what=f"{what} lse against the emulation")
        share = (out == emu).float().mean().item()
        _say(f"  {what} out: {share:.6f} of the values the emulation's bf16")
        if share < 0.99:
            raise AssertionError(f"{what}: out equals the emulation at "
                                 f"{share:.6f} of the values, under 0.99")
        rows["fwd"]["equal_to_emulation"] = share
        padded_args = (*A._padded(q, k, v, g), ref_lse, delta)
        emulated = (A.attention_dq_emulation(*padded_args, scale=A._scale(d)),
                    *A.attention_dkdv_emulation(*padded_args,
                                                scale=A._scale(d)))
        shares = {}
        for part, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                   emulated):
            want = want[..., :d]
            _close(got, want, atol=1e-5 * want.float().abs().max().item(),
                   rtol=2.0 ** -7, what=f"{what} {part} against the emulation")
            shares[part] = (got == want).float().mean().item()
        _say(f"  {what} dq, dk, dv: {json.dumps(shares)} of the values the "
             "emulation's bf16")
        if min(shares.values()) < 0.99:
            raise AssertionError(f"{what}: the gradients equal the emulation "
                                 f"at {shares} of the values, under 0.99")
        rows["dq"]["equal_to_emulation"] = shares["dq"]
        rows["dkdv"]["equal_to_emulation"] = min(shares["dk"], shares["dv"])
        if padded <= 64 and share < 0.997:
            # the wgmma forward at D <= 64, held as the one at 80 and 128
            # was first held (PERF.md)
            raise AssertionError(f"{what}: out equals the emulation at "
                                 f"{share:.6f} of the values, under 0.997")
        for name, kernel in zip(("fwd", "dq", "dkdv"),
                                (A.narrow_forward_kernel(d),
                                 *A.narrow_gradient_kernels(d, tq, tk))):
            report = (ptxas or {}).get(f"{kernel} D={padded}", {})
            rows[name].update(kernel=f"{kernel}<{padded}>",
                              repeats_bit_for_bit=True,
                              registers=report.get("registers"),
                              spill_bytes=report.get("spill_stores", 0)
                              + report.get("spill_loads", 0))
            _say(f"  {what} {name}: {rows[name]['kernel']}, "
                 f"{rows[name]['registers']} registers, "
                 f"{rows[name]['spill_bytes']} spill bytes; a second "
                 "launch gave the same bits")
    # bf16 rows are timed; float32 ones (the CUDA-core kernels, off the
    # bf16 paths) only at the head dims over 64
    if dtype != torch.bfloat16 and d <= 64:
        return rows

    rows["fwd"].update(
        ms=_time_ms(lambda: A.attention_fwd(q, k, v), flush),
        plain_ms=_time_ms(lambda: A.attention_fwd_reference(q, k, v), flush),
        device_ms=_time_ms(lambda: A.attention_fwd(q, k, v), flush,
                           spin_cycles=SPIN_CYCLES))
    rows["dq"].update(
        ms=_time_ms(lambda: A.attention_dq(*args), flush),
        plain_ms=_time_ms(lambda: A.attention_dq_reference(*args), flush),
        device_ms=_time_ms(lambda: A.attention_dq(*args), flush,
                           spin_cycles=SPIN_CYCLES))
    rows["dkdv"].update(
        ms=_time_ms(lambda: A.attention_dkdv(*args), flush),
        plain_ms=_time_ms(lambda: A.attention_dkdv_reference(*args), flush),
        device_ms=_time_ms(lambda: A.attention_dkdv(*args), flush,
                           spin_cycles=SPIN_CYCLES))
    # The library yardstick on [1, BH, T, D] views (flash attention in
    # bf16, its float32 route in float32): the forward, and the forward
    # with the backward of all three
    # inputs, against the port's forward + delta + dq + dk/dv through its
    # autograd Function. SDPA's backward computes dq, dk and dv in one, so
    # dq and dk/dv alone have no library call.
    q4, k4, v4 = (t.detach().unsqueeze(0).requires_grad_()
                  for t in (q, k, v))
    g4 = g.unsqueeze(0)
    lib = F.scaled_dot_product_attention(q4, k4, v4)
    lib_err = (lib[0].float() - ref.float()).abs().max().item()
    _say(f"  {what} SDPA yardstick: max abs err {lib_err:.3e}")
    leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))

    def ours_fb():
        torch.autograd.grad(A.fused_attention(*leaves), leaves, g)

    def lib_fb():
        torch.autograd.grad(F.scaled_dot_product_attention(q4, k4, v4),
                            (q4, k4, v4), g4)

    # the backward alone, from one kept graph: delta, dq and dk/dv
    kept = A.fused_attention(*leaves)

    def ours_b():
        torch.autograd.grad(kept, leaves, g, retain_graph=True)

    with torch.no_grad():
        rows["fwd"]["library_ms"] = _time_ms(
            lambda: F.scaled_dot_product_attention(q4, k4, v4), flush)
        if dtype == torch.bfloat16:
            rows["fwd"]["library_device_ms"] = _time_ms(
                lambda: F.scaled_dot_product_attention(q4, k4, v4), flush,
                spin_cycles=SPIN_CYCLES)
            _say(f"  {what} SDPA: {rows['fwd']['library_ms']:.4f} ms, "
                 f"{rows['fwd']['library_device_ms']:.4f} ms with the "
                 "launch enqueued ahead of the card")
    fb = {"kernels_fwd_bwd_ms": _time_ms(ours_fb, flush),
          "sdpa_fwd_bwd_ms": _time_ms(lib_fb, flush),
          "kernels_bwd_ms": _time_ms(ours_b, flush)}
    # SDPA's backward gives dq, dk and dv in one: its time is what the
    # forward + backward takes beyond the forward
    fb["sdpa_bwd_ms"] = fb["sdpa_fwd_bwd_ms"] - rows["fwd"]["library_ms"]
    for name in ("fwd", "dq", "dkdv"):
        rows[name].update(fb)
        r = rows[name]
        r["bound_share"] = r["bound_ms"] / r["ms"]
        passes = (f", {_k3_passes(name, d)} tensor-core passes a tile pair"
                  if dtype == torch.bfloat16
                  else f", three TF32 products a product; on the CUDA "
                  f"cores {r['bound_cuda_core_ms']:.4f} ms, one TF32 "
                  f"product {r['bound_one_tf32_ms']:.4f} ms"
                  if "bound_cuda_core_ms" in r else ", CUDA cores")
        _say(f"  {what} {name}: kernel {r['ms']:.4f} ms, plain "
             f"{r['plain_ms']:.4f} ms, SDPA "
             + (f"{r['library_ms']:.4f} ms" if r["library_ms"] else "none")
             + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
             f"{100 * r['bound_share']:.1f}% of it reached{passes}"
             + (f"; ex2 floor {r['ex2_floor_ms']:.4f} ms"
                if "ex2_floor_ms" in r else "")
             + f"); {r['device_ms']:.4f} ms with the launch enqueued ahead "
             "of the card")
    _say(f"  {what} forward + backward: kernels "
         f"{fb['kernels_fwd_bwd_ms']:.4f} ms, SDPA "
         f"{fb['sdpa_fwd_bwd_ms']:.4f} ms; backward alone (delta, dq, "
         f"dk/dv): kernels {fb['kernels_bwd_ms']:.4f} ms, SDPA "
         f"{fb['sdpa_bwd_ms']:.4f} ms (forward + backward less forward)")
    return rows


def phase_kernels(ptxas=None):
    """Every kernel against its plain version at its cases; ``ptxas``
    (``phase_build``'s K3 rows) names the registers of the wgmma gradient
    kernels in their rows."""
    _say("[kernels] patchify_conv against patchify_conv_reference on the "
         f"card, x f32 [{BATCH}, res, res, 3]")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    bf16 = torch.bfloat16
    rows = {"patchify_fwd": [_patchify_case(*case, flush)
                             for case in K1_CASES]}
    _say("[kernels] patchify_conv_dw against patchify_conv_dw_reference")
    rows["patchify_dw"] = [_dw_case(*case, flush) for case in DW_CASES]
    _say("[kernels] hungarian_lap against hungarian_lap_reference and scipy")
    rows["lap"] = [_lap_case(b, o, p, seed, flush, edges)
                   for b, o, p, seed, edges in K2_CASES]
    _say("[kernels] attention_fwd, attention_dq and attention_dkdv against "
         "their plain versions")
    for name in ("attention_fwd", "attention_dq", "attention_dkdv"):
        rows[name] = []
    seed = K3_FIRST_SEED
    for dtype in (torch.bfloat16, torch.float32):  # the 1280 encoder first
        for shape in K3_SHAPES:
            case = _attention_case(*shape, dtype, seed, flush, ptxas)
            seed += 1
            for name in ("fwd", "dq", "dkdv"):
                rows[f"attention_{name}"].append(case[name])
    return rows


# the matchers phase's problems: (B, O, P, seed), the flagship's and 300
# queries
MATCHER_CASES = ((8, 32, 96, 50), (8, 32, 300, 51))


def phase_matchers():
    """The approximate matchers and the host oracle on CUDA tensors, held
    against K2 on tie-free random costs (n = 0 in the first problem and O
    in the last): ``auction_lap``'s total cost within ``n * eps`` of K2's
    (its bound, eps = 1e-2 * spread / (n + 1) as the auction takes it, plus
    1e-4 relative for the float32 sums); ``greedy_lap`` unshuffled and
    shuffled by a generator a valid assignment (each active row one
    prediction, each prediction at most one row, the padded rows empty);
    ``hungarian_host`` K2's mask bit for bit. None of them is a kernel;
    their host-clock times are shown beside K2's."""
    from boosted_detr_torch.ops import lap as L
    from boosted_detr_torch.ops import matching as M

    _say("[matchers] auction_lap, greedy_lap and hungarian_host against K2 "
         "on CUDA tensors")
    rows = []
    for b, o, p, seed in MATCHER_CASES:
        cost_np, n_np = _lap_inputs(b, o, p, seed, edges=True)
        cost = torch.from_numpy(cost_np).cuda()
        n = torch.from_numpy(n_np).cuda()
        exact = L.hungarian_lap(cost, n)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        masks = {"auction": M.auction_lap(cost, n),
                 "greedy": M.greedy_lap(cost, n),
                 "greedy shuffled": M.greedy_lap(cost, n, generator=gen),
                 "host": M.hungarian_host(cost, n)}
        what = f"[{b}, {o}, {p}]"
        for label, mask in masks.items():
            m = mask.cpu().numpy()
            if mask.device != cost.device:
                raise AssertionError(f"{label} {what}: mask on {mask.device}")
            for i in range(b):
                ni = int(n_np[i])
                if not ((m[i, :ni].sum(1) == 1).all() and (m[i, ni:] == 0)
                        .all() and (m[i].sum(0) <= 1).all()):
                    raise AssertionError(f"{label} {what}: problem {i} is "
                                         "not a valid assignment")
        totals = {k: (v * cost).sum(dim=(1, 2)).cpu().numpy().astype(
            np.float64) for k, v in dict(masks, K2=exact).items()}
        spread = np.array([np.ptp(cost_np[i, :max(int(n_np[i]), 1)])
                           for i in range(b)])
        slack = n_np * 1e-2 * np.maximum(spread, 1e-6) / (n_np + 1.0)
        over = totals["auction"] - totals["K2"]
        if not (over <= slack + 1e-4 * totals["K2"] + 1e-6).all():
            raise AssertionError(f"auction {what}: {over} over K2's cost, "
                                 f"bound n*eps {slack}")
        if not torch.equal(masks["host"], exact):
            raise AssertionError(f"hungarian_host {what}: not K2's mask")
        greedy_over = totals["greedy"] - totals["K2"]
        times = {k: _host_ms(fn) for k, fn in (
            ("auction_ms", lambda: M.auction_lap(cost, n)),
            ("greedy_ms", lambda: M.greedy_lap(cost, n)),
            ("host_ms", lambda: M.hungarian_host(cost, n)),
            ("k2_ms", lambda: L.hungarian_lap(cost, n)))}
        _say(f"  {what}: all four valid; auction over K2's cost by at most "
             f"{over.max():.4e} (bound n*eps up to {slack.max():.4e}); "
             f"greedy over it by up to {greedy_over.max():.4e} (not held); "
             f"hungarian_host K2's mask bit for bit; host clock: " + ", ".join(
                 f"{k[:-3]} {v:.3f} ms" for k, v in times.items()))
        rows.append(dict(shape=what, auction_over=float(over.max()),
                         auction_bound=float(slack.max()),
                         greedy_over=float(greedy_over.max()), **times))
    return rows


def _wrapper(name):
    """A kernel's module and the names of its wrapper and plain version."""
    module, wrapper, plain = KERNELS[name][:3]
    return (importlib.import_module(f"boosted_detr_torch.ops.{module}"),
            wrapper, plain)


def _reset_launches():
    for name in KERNELS:
        module, wrapper, _ = _wrapper(name)
        getattr(module, wrapper).launches = 0


def _launches():
    return {name: getattr(*_wrapper(name)[:2]).launches for name in KERNELS}


@contextlib.contextmanager
def _gradients(state, params):
    """Each parameter's gradient as the backward leaves it, recorded before
    the optimizer clips it and adds the momentum (both in place)."""
    grads = {}
    optimizer = state.optimizer

    def step():
        grads.update({k: p.grad.clone() for k, p in params.items()
                      if p.grad is not None})
        type(optimizer).step(optimizer)

    optimizer.step = step
    try:
        yield grads
    finally:
        del optimizer.step


@contextlib.contextmanager
def _plain_versions(names):
    """The named kernels' wrappers replaced by their plain versions."""
    saved = {name: getattr(*_wrapper(name)[:2]) for name in names}
    for name in names:
        module, wrapper, plain = _wrapper(name)
        setattr(module, wrapper, getattr(module, plain))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(_wrapper(name)[0], KERNELS[name][1], fn)


def _expect(**per_run):
    """Launches of each kernel per forward or per step: 0 where unnamed."""
    return {name: per_run.get(name, 0) for name in KERNELS}


_K3 = ("attention_fwd", "attention_dq", "attention_dkdv")
_BACKWARD = ("patchify_dw", "attention_dq", "attention_dkdv")
# Leaves whose gradient is too small to move a float32 weight in a few
# steps: a key-projection bias shifts all of one query's logits alike, which
# softmax ignores (every path); with fresh queries, every boosted block's
# self-attention sees the shared object queries, all zero at the start and
# a few 1e-5 apart after a few steps, whose logits are equal to float32
# precision (the boosted path).
_ZERO_GRADIENT = ("key_projection.bias",)
_FRESH_SELF_ATTENTION = ("self_attention.attention.query_projection.weight",
                         "self_attention.attention.key_projection.weight")


# The paths: label, ModelConfig keywords (over _path_config's), launches per
# forward (serving) and per train step, and the kernels the plain
# comparison swaps out; a path that runs the fused attention names its K3
# forward kernels, {name: launches a forward}, which its profiles are held
# to, and may name its gradient kernels (``grad_kernels``, {name: launches
# a train step}), which its train step's profile is held to; a path may
# also name its parameter count (the JAX
# model's, by jax.eval_shape on the CPU), and the boosted path its model,
# its TrainConfig keywords, its matcher problem, the weak learner its
# staged steps train and their launches.
PATHS = {
    "flagship": dict(
        res=RES, cfg=dict(backbone="resnet", stem="patchify8",
                          norm="batchnorm"),
        forward=_expect(patchify_fwd=1),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1),
        serving_plain=("patchify_fwd",)),
    # 1600 encoder tokens: 4 encoder, 4 cross and 3 decoder self-attentions
    "flagship_1280": dict(
        res=HR_RES, cfg=dict(backbone="resnet", stem="patchify8",
                             norm="batchnorm", use_pallas_attention=True),
        forward=_expect(patchify_fwd=1, attention_fwd=11),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1, attention_fwd=11,
                     attention_dq=11, attention_dkdv=11),
        fwd_kernels=dict(attn_fwd_wgmma_kernel=11),
        serving_plain=("patchify_fwd",) + _K3),
    # 8 ViT blocks over 1600 patches, then the 11 attentions of DETR
    "vit_p16": dict(
        res=RES, cfg=dict(backbone="vit", norm="batchnorm",
                          use_pallas_attention=True),
        forward=_expect(patchify_fwd=1, attention_fwd=19),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1, attention_fwd=19,
                     attention_dq=19, attention_dkdv=19),
        fwd_kernels=dict(attn_fwd_wgmma_kernel=19),
        serving_plain=("patchify_fwd",) + _K3),
    # ViT-Huge's widths (Dosovitskiy et al., ICLR 2021, Table 1: 32 layers,
    # width 1280, MLP 5120, 16 heads, so D = 80, which K3 takes as built)
    # at patch 16, since 640 is no multiple of 14: 1600 patches, K1 at
    # P=16 -> 1280, 32 fused attentions in the blocks and DETR's 11 at D=32
    "vit_h16": dict(
        res=RES, cfg=dict(backbone="vit_p16_d32_w1280_h16", norm="batchnorm",
                          use_pallas_attention=True),
        params=651_553_406,
        forward=_expect(patchify_fwd=1, attention_fwd=43),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1, attention_fwd=43,
                     attention_dq=43, attention_dkdv=43),
        fwd_kernels=dict(attn_fwd_wgmma_kernel=43),
        serving_plain=("patchify_fwd",) + _K3),
    # ViT-Large's depth, width and MLP (Dosovitskiy et al., ICLR 2021,
    # Table 1: 24 layers, width 1024, MLP 4096) over 4 heads, so D = 256:
    # no published model has that head dim; a configuration users can
    # write, which runs K3's wide kernels on a main path. 1600 patches, K1
    # at P=16 -> 1024, 24 fused attentions in the blocks at
    # [32, 1600, 1600, 256] and DETR's 11 at D = 32
    "vit_l16_h4": dict(
        res=RES, cfg=dict(backbone="vit_p16_d24_w1024_h4", norm="batchnorm",
                          use_pallas_attention=True),
        params=318_726_526,
        forward=_expect(patchify_fwd=1, attention_fwd=35),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1, attention_fwd=35,
                     attention_dq=35, attention_dkdv=35),
        fwd_kernels=dict(attn_fwd_wide_mma_kernel=24,
                         attn_fwd_wgmma_kernel=11),
        serving_plain=("patchify_fwd",) + _K3),
    # vit_l16_h4 in float32 (compute_dtype="float32", as a user sets it in
    # ModelConfig), trained only (one warm-up and three timed steps: the
    # run's time limit; its forward kernels are unchanged and held in the
    # kernels phase): its 24 blocks run the float32 forward on the CUDA
    # cores (attn_fwd_wide_kernel) and dq and dk/dv at [32, 1600, 1600,
    # 256] on the tensor cores, three TF32 products a product; DETR's 11
    # attentions at D = 32 the float32 CUDA-core kernels; K1 its float32
    # route
    "vit_l16_h4_f32": dict(
        res=RES, cfg=dict(backbone="vit_p16_d24_w1024_h4", norm="batchnorm",
                          use_pallas_attention=True,
                          compute_dtype="float32"),
        params=318_726_526, train_only=(1, 3),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1, attention_fwd=35,
                     attention_dq=35, attention_dkdv=35),
        fwd_kernels=dict(attn_fwd_wide_kernel=24, attn_fwd_kernel=11),
        grad_kernels=dict(attn_dq_wide_tf32_kernel=24,
                          attn_dkdv_wide_tf32_kernel=24, attn_dq_kernel=11,
                          attn_dkdv_kernel=11)),
    # 4 weak learners (a 1-block encoder, a decoder block and three heads
    # of hidden width 256 each); the intermediate losses fold the 4 blocks'
    # matching into one K2 launch
    "boosted": dict(
        res=RES, cfg=dict(backbone="resnet", stem="patchify8",
                          norm="batchnorm", early_exit_criterion="stability"),
        model="BoostedDETR", train=dict(use_intermediate_losses=True),
        params=29_334_520, lap_shape=(4 * BATCH, 32, 96),
        forward=_expect(patchify_fwd=1),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1),
        serving_plain=("patchify_fwd",),
        train_block=1, staged=_expect(patchify_fwd=1, lap=1),
        may_stay=_FRESH_SELF_ATTENTION),
    # bench.py's BENCH_NORM=skipinit: the 640 flagship with no BatchNorm:
    # weight-standardised convs (the stem's through K1 on standardised
    # weights, its gradient back through the standardisation and the gain),
    # skip_gain on the 13 residual branches, GroupNorm in the neck, no norm
    # in the heads
    "skipinit": dict(
        res=RES, cfg=dict(backbone="resnet", stem="patchify8",
                          norm="skipinit"),
        params=28_794_379, forward=_expect(patchify_fwd=1),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1),
        serving_plain=("patchify_fwd",)),
    # bench.py's BENCH_BACKBONE=efficientnet_b4: the reference's own
    # backbone, 32 MBConvSE blocks (depthwise convs, squeeze-excite,
    # swish), stochastic depth to 0.2 in training; no hand-written kernel
    # in the forward
    "efficientnet_b4": dict(
        res=RES, cfg=dict(backbone="efficientnet_b4", stem="patchify8",
                          norm="batchnorm"),
        params=23_081_158, forward=_expect(), step=_expect(lap=1),
        serving_plain=()),
    # ModelConfig()'s defaults, the package's default model: the
    # EfficientNet-lite backbone at 560x560 (18x18 tokens), conv7 stem name
    # (unread), no fused stem
    "efficientnet_lite": dict(
        res=560, cfg=dict(backbone="efficientnet_lite", stem="conv7",
                          norm="batchnorm", use_pallas_stem=False),
        params=8_751_998, forward=_expect(), step=_expect(lap=1),
        serving_plain=()),
    # benchmarks/run_benchmarks.py:219-269 (bench_other_models): the 640
    # flagship's config with the panoptic mask head at mask_size 96 (its
    # attention maps over the 20x20 grid, a U-Net at 96x96, float32 mask
    # logits), trained on the detection loss plus the matched mask loss,
    # one K2 assignment for both; served raw (masks [8, 96, 96, 96]), then
    # segmented
    "panoptic": dict(
        res=RES, cfg=dict(backbone="resnet", stem="patchify8",
                          norm="batchnorm"),
        model="DETRPanoptic", model_kw=lambda cfg: dict(mask_size=MASK_SIZE),
        builder="panoptic", serve="panoptic", params=29_118_270,
        lap_shape=(BATCH, 32, 96), forward=_expect(patchify_fwd=1),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1),
        serving_plain=("patchify_fwd",)),
    # the same source's classifier pre-trainer: the trunk (no detection
    # heads) and a multi-label classifier head over the 82 categories,
    # applied after every decoder block; no matching, so no K2
    "pretrainer": dict(
        res=RES, cfg=dict(backbone="resnet", stem="patchify8",
                          norm="batchnorm"),
        model="DETRMultiClassifier",
        model_kw=lambda cfg: dict(num_classifier_classes=cfg.num_categories),
        builder="pretrain", serve="classifier", params=27_926_354,
        forward=_expect(patchify_fwd=1),
        step=_expect(patchify_fwd=1, patchify_dw=1),
        serving_plain=("patchify_fwd",)),
    # The 640 flagship at DINO's 900 queries (Zhang et al., ICLR 2023) and
    # max_objects=120, trained only (one warm-up and one timed step, the
    # profile and the loss check): K2 once a step on its columns route at
    # [8, 120, 900], whose 432 KB of cost rows pass shared memory
    "flagship_900q": dict(
        res=RES, cfg=dict(backbone="resnet", stem="patchify8",
                          norm="batchnorm", num_object_preds=900,
                          max_objects=120),
        params=29_030_014, lap_shape=(BATCH, 120, 900), train_only=(1, 1),
        step=_expect(patchify_fwd=1, patchify_dw=1, lap=1)),
}
MASK_SIZE = 96
# the boosted path's early-exit request (PERF.md: the stability criterion
# at tau 1.5, the README's recommendation) and its incremental request
# (confidence 1.1: no image exits, all 4 weak learners run)
EXIT_TAU, INCREMENTAL_THRESHOLD = 1.5, 1.1
STAGED_STEPS = 3


def _randomize_running_stats(model, seed):
    from boosted_detr_torch.models.backbone import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)


def _randomize_skip_gains(model, seed):
    """Each ``skip_gain`` of a norm-free (``skipinit``) backbone drawn from
    N(0, 0.2^2): at their zero init the residual branches add nothing, and
    a served or trained comparison would never see their convs."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("skip_gain"):
                p.copy_(torch.randn((), generator=gen) * 0.2)


def _known_attributes(text, names):
    """True when ``text`` is a ", "-joined run of names from ``names``
    (some names hold ", " themselves, e.g. "letters, numbers")."""
    part = ""
    for token in filter(None, text.split(", ")):
        part = f"{part}, {token}" if part else token
        if part in names:
            part = ""
    return part == ""


def _codec():
    """The flagship's vocabularies (bench.py): COCO's 80 categories and
    Fashionpedia's 294 attributes, each with <PAD> and <OOV>."""
    from boosted_detr_torch.data import vocabularies
    from boosted_detr_torch.data.codec import TextCodec

    return TextCodec({
        "category": vocabularies.vocab_dict("COCO")["category"],
        "attribute": vocabularies.vocab_dict("Fashionpedia")["attribute"]})


def _path_config(name, codec):
    import boosted_detr_torch as bt

    path = PATHS[name]
    res = path["res"]
    kw = dict(image_size=(res, res), use_pallas_stem=True,
              compute_dtype="bfloat16", max_objects=32, matcher="pallas",
              num_categories=len(codec.category_vocab),
              num_attributes=len(codec.attribute_vocab))
    return bt.ModelConfig(**dict(kw, **path["cfg"]))


def _build(path, cfg, **kw):
    """The path's model (``DETR`` unless it names another, with its
    keywords) on cuda, the entry point's default."""
    import boosted_detr_torch as bt

    kw = dict(path.get("model_kw", lambda cfg: {})(cfg), **kw)
    return getattr(bt, path.get("model", "DETR"))(cfg, **kw)


def _serve(path, model, images, codec):
    """One request of a path as its user makes it: text through ``predict``
    and the codec (detection); the raw dict with ``masks`` through
    ``predict(decode_text=False)`` and its panoptic segments
    (``serve="panoptic"``); the class probabilities [B, 1, C] through
    ``make_predict_step`` (``serve="classifier"``)."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.train import metrics
    from boosted_detr_torch.train.steps import make_predict_step

    kind = path.get("serve", "text")
    if kind == "text":
        return bt.predict(model, images, codec)
    if kind == "panoptic":
        raw = bt.predict(model, images, decode_text=False)
        return raw, metrics.detr_panoptic_segments(raw)
    x = torch.from_numpy(images).to(model.device)
    return make_predict_step(model)(x).cpu().numpy()


def _raw(path, model, images):
    """The request's raw outputs as a dict of numpy arrays."""
    import boosted_detr_torch as bt

    if path.get("serve") == "classifier":
        return {"classes": _serve(path, model, images, None)}
    return bt.predict(model, images, decode_text=False)


def phase_serving(name):
    """One path's serving: the model in eval mode with random running
    statistics, a warm-up request, then REQUESTS requests through
    ``predict`` with the launch counters read around them."""
    import boosted_detr_torch as bt

    path = PATHS[name]
    res = path["res"]
    codec = _codec()
    cfg = _path_config(name, codec)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _build(path, cfg, seed=0)
    model.eval()  # a server holds its model in eval mode
    _randomize_running_stats(model, seed=1)
    _randomize_skip_gains(model, seed=5)
    n_params = sum(p.numel() for p in model.parameters())
    _say(f"[serving {name}] {type(model).__name__} {res}x{res}, backbone "
         f"{cfg.backbone}, norm {cfg.norm}, fused attention "
         f"{cfg.use_pallas_attention}, "
         f"{n_params} parameters, built in {time.perf_counter() - t0:.1f} s "
         f"on {model.device}")
    if n_params != path.get("params", n_params):
        raise AssertionError(f"{n_params} parameters, the JAX model has "
                             f"{path['params']}")
    rng = np.random.default_rng(0)
    requests = [rng.uniform(0.0, 1.0, (BATCH, res, res, 3)).astype(np.float32)
                for _ in range(REQUESTS)]

    _serve(path, model, requests[0], codec)  # warm-up: cuDNN, cuBLAS plans
    torch.cuda.synchronize()
    _reset_launches()
    results, latencies = [], []
    for images in requests:
        t0 = time.perf_counter()
        results.append(_serve(path, model, images, codec))
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = _launches()
    _say(f"  kernel launches over {REQUESTS} requests: {launches}")
    want = {k: n * REQUESTS for k, n in path["forward"].items()}
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")
    for i, ms in enumerate(latencies):
        _say(f"  request {i}: {BATCH} images in {ms:.2f} ms")
    total_s = sum(latencies) / 1e3
    _say(f"  {REQUESTS * BATCH / total_s:.2f} images/s over {REQUESTS} "
         f"requests (host clock, H2D copy and host postprocess included)")
    kind = path.get("serve", "text")
    if kind == "classifier":
        texts = []
        for probs in results:
            if probs.shape != (BATCH, 1, cfg.num_categories) or not (
                    np.isfinite(probs).all() and (probs >= 0).all()
                    and (probs <= 1).all()):
                raise AssertionError(f"class probabilities {probs.shape} "
                                     "off [0, 1] or not finite")
        _say(f"  outputs: class probabilities [{BATCH}, 1, "
             f"{cfg.num_categories}] in [0, 1]")
    elif kind == "panoptic":
        s = MASK_SIZE
        for raw, segments in results:
            masks = raw["masks"]
            if (masks.shape != (BATCH, cfg.num_object_preds, s, s)
                    or not np.isfinite(masks).all()):
                raise AssertionError(f"masks {masks.shape} not [{BATCH}, "
                                     f"{cfg.num_object_preds}, {s}, {s}] or "
                                     "not finite")
            for canvas, cats in segments:
                if (canvas.shape != (s, s) or canvas.max() >= len(cats)
                        or canvas.min() < -1 or (cats < 1).any()
                        or (cats >= cfg.num_categories).any()):
                    raise AssertionError("a panoptic canvas is off")
        kept = [len(cats) for _, cats in results[0][1]]
        _say(f"  outputs: masks [{BATCH}, {cfg.num_object_preds}, {s}, {s}] "
             f"finite; panoptic segments of request 0 per image {kept}")
        # one request's text through the codec
        texts = [codec.decode_predictions(results[0][0])]
    else:
        texts = results
    # the boosted ensemble's outputs are sums over its n weak learners
    n = cfg.num_decoder_blocks if path.get("model") == "BoostedDETR" else 1
    words = set(codec.category_vocab)
    attrs = set(codec.attribute_vocab[2:])
    for cats, atts, boxes in texts:
        assert cats.shape == atts.shape == (BATCH, cfg.num_object_preds)
        assert set(cats.ravel()) <= words
        assert all(_known_attributes(a, attrs) for a in atts.ravel())
        assert boxes.shape == (BATCH, cfg.num_object_preds, 4)
        assert np.isfinite(boxes).all()
        assert ((boxes > -n) & (boxes < 2 * n)).all()

    raw = _raw(path, model, requests[0])
    if kind != "classifier":
        sums = raw["category"].sum(-1)
        if not np.allclose(sums, n, atol=1e-5 * n):
            raise AssertionError(f"softmax rows sum to {sums.min()}.."
                                 f"{sums.max()}")
        assert ((raw["attribute"] >= 0) & (raw["attribute"] <= n)).all()
        _say(f"  outputs: categories and attributes from the vocabulary, "
             f"{n} softmax a row summed to {n}, boxes in ({-n}, {2 * n})")

    # The same model with the path's kernels on their plain versions on the
    # card: the stem (K1-fwd) and K3 where it runs. Each agrees to one bf16
    # rounding of its results (K1-fwd in about one value of 10^4, where its
    # float32 sums straddle a rounding boundary); that propagates through bf16
    # compute to the heads' bf16 logits, where one rounding (2**-8 of a
    # logit of a few units) moves a probability by about 1%. Each output is
    # held as a whole to 5e-2 of its own L2 norm (a category probability is
    # ~0.012 on average, so a flat bound would not see a wrong K3), and
    # each value to 5e-2. The panoptic mask logits (float32 from a bf16
    # U-Net, a few units large) each to 5e-2 plus 5e-2 of their own size.
    swapped = path["serving_plain"]
    rel_errs = {}
    if not swapped:
        _say("  no hand-written kernel in this forward: no plain comparison")
    else:
        with _plain_versions(swapped):
            plain = _raw(path, model, requests[0])
    for key in sorted(set(raw) - {"exit_block"}) if swapped else ():
        got, want = torch.from_numpy(raw[key]), torch.from_numpy(plain[key])
        what = f"serving {key}, kernels vs plain {'/'.join(swapped)}"
        _close(got, want, atol=5e-2, rtol=5e-2 if key == "masks" else 0.0,
               what=what)
        rel_errs[key] = _norm_rel(got, want)
        _say(f"  {what}: L2 norm of the difference {rel_errs[key]:.3e} of "
             f"the plain output's (held to 5e-2)")
        if not rel_errs[key] <= 5e-2:
            raise AssertionError(f"{what}: off the plain output")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _say(f"  peak device memory allocated: {peak_gb:.2f} GiB (model, "
         "requests and the plain comparison)")
    return {"images_per_s": REQUESTS * BATCH / total_s,
            "latency_ms": latencies, "launches": launches,
            "plain_norm_rel_err": rel_errs, "peak_memory_gib": peak_gb,
            "model": model, "codec": codec, "images": requests[0]}


def _counted(fn, want, what):
    """``fn()`` with the launch counters set to 0 just before it and read
    just after, held to ``want``; returns (result, ms on the host clock,
    launches)."""
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _launches()
    if launches != want:
        raise AssertionError(f"{what}: expected {want}, got {launches}")
    return out, ms, launches


def _renormalized(out):
    """A forward's output with its category renormalized per slot, as the
    early-exit routes return it."""
    cat = out["category"].float()
    return dict(out, category=cat / cat.sum(-1, keepdim=True).clamp_min(1e-9))


def phase_early_exit(name, model, images):
    """The boosted path's early-exit serving: one request through
    ``predict(early_exit_threshold=EXIT_TAU)`` (the config's stability
    criterion), each image's output held against the full forward's output
    at the block it reports, renormalized; and one incremental request
    (``make_incremental_predict`` at confidence INCREMENTAL_THRESHOLD, which
    no image reaches) held within 1e-5 against the full forward's last
    block, renormalized. Both run the stem once (K1-fwd) and are counted."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.models import early_exit
    from boosted_detr_torch.train.steps import make_predict_step

    path = PATHS[name]
    x = torch.from_numpy(images).cuda()
    outs = make_predict_step(model, return_intermediate=True)(x)
    preds, ms, launches = _counted(
        lambda: bt.predict(model, images, decode_text=False,
                           early_exit_threshold=EXIT_TAU),
        path["forward"], "early-exit request")
    exits = preds["exit_block"]
    _say(f"[early exit {name}] one request of {BATCH} at stability tau "
         f"{EXIT_TAU}: {ms:.2f} ms (host clock), exit blocks {exits.tolist()}"
         f", launches {launches}")

    want = {k: torch.stack([_renormalized(outs[int(e)])[k][b]
                            for b, e in enumerate(exits)]).cpu()
            for k in ("category", "attribute", "boxes")}
    worst = max(_close(torch.from_numpy(preds[k]), want[k], atol=1e-6,
                       rtol=0.0, what=f"early exit {k} against the full "
                       f"forward at each image's exit block")
                for k in want)
    row = {"early_exit_ms": ms, "exit_block": exits.tolist(),
           "early_exit_max_abs_err": worst, "early_exit_launches": launches}

    incremental = early_exit.make_incremental_predict(
        model, INCREMENTAL_THRESHOLD, "confidence")
    (preds, blocks_run), ms, launches = _counted(
        lambda: incremental(x), path["forward"], "incremental request")
    _say(f"[early exit {name}] incremental request at confidence "
         f"{INCREMENTAL_THRESHOLD}: {blocks_run} of "
         f"{model.config.num_decoder_blocks} blocks run, {ms:.2f} ms (host "
         f"clock, one readback a block), launches {launches}")
    if blocks_run != model.config.num_decoder_blocks:
        raise AssertionError("the incremental request stopped early")
    last = _renormalized(outs[-1])
    worst = max(_close(preds[k], last[k], atol=1e-5, rtol=0.0,
                       what=f"incremental {k} against the full forward")
                for k in ("category", "attribute", "boxes"))
    row.update(incremental_ms=ms, blocks_run=blocks_run,
               incremental_max_abs_err=worst,
               incremental_launches=launches)
    row["modes"] = {mode: _incremental_mode(name, model, images, mode, kw)
                    for mode, kw in INCREMENTAL_MODES.items()}
    return row


# The incremental requests of the other query modes, each on a model of the
# boosted path's widths built for it (ModelConfig keywords): carried
# queries, the confidence freeze (its threshold set between two middle
# slot confidences of block 0, so that some slots freeze and some do not),
# and one shared encoder (num_encoder_blocks deep, run once).
INCREMENTAL_MODES = {"carry": dict(boosted_queries="carry"),
                     "confidence": dict(boosted_queries="confidence"),
                     "shared_encoder": dict(boosted_shared_encoder=True)}


def _incremental_mode(name, served, images, mode, kw):
    """One incremental request (stability at EXIT_TAU) of a BoostedDETR
    built for ``mode``, held within 1e-5 against its full forward's
    intermediate output at the exit block, renormalized; the exit block
    against the first block the same stop test passes on the full
    forward's outputs; launches as the path's forward."""
    from boosted_detr_torch.models import early_exit
    from boosted_detr_torch.train.steps import make_predict_step

    path = PATHS[name]
    cfg = served.config.replace(**kw)
    model = _build(path, cfg, seed=0).eval()
    _randomize_running_stats(model, seed=1)
    x = torch.from_numpy(images).cuda()
    if mode == "confidence":
        with torch.inference_mode():
            conf = model(x, return_intermediate=True)[0]["category"].float()
        lo, hi = conf.amax(-1).flatten().sort().values[
            conf.shape[0] * conf.shape[1] // 2 - 1:][:2].tolist()
        model.config = cfg = cfg.replace(boosted_carry_threshold=(lo + hi) / 2)
    outs = make_predict_step(model, return_intermediate=True)(x)
    stop = early_exit._make_stop_check(EXIT_TAU, "stability")
    want_run = next((i + 1 for i in range(1, len(outs))
                     if stop(outs[i - 1], outs[i])), len(outs))
    incremental = early_exit.make_incremental_predict(model, EXIT_TAU,
                                                      "stability")
    (preds, blocks_run), ms, launches = _counted(
        lambda: incremental(x), path["forward"], f"incremental {mode}")
    frozen = ""
    if mode == "confidence":  # the slots block 0 freezes for block 1 on
        share = (outs[0]["category"].float().amax(-1)
                 >= cfg.boosted_carry_threshold).float().mean().item()
        frozen = (f", threshold {cfg.boosted_carry_threshold:.4f} freezes "
                  f"{100 * share:.1f}% of the slots at block 0")
    _say(f"[early exit {name}] incremental request, {mode} mode, stability "
         f"tau {EXIT_TAU}: {blocks_run} of {len(outs)} blocks run (the full "
         f"forward's outputs stop at {want_run}), {ms:.2f} ms (host clock), "
         f"launches {launches}{frozen}")
    if blocks_run != want_run:
        raise AssertionError(f"incremental {mode}: stopped after "
                             f"{blocks_run} blocks, the full forward's "
                             f"outputs after {want_run}")
    want = _renormalized(outs[blocks_run - 1])
    worst = max(_close(preds[k], want[k], atol=1e-5, rtol=0.0,
                       what=f"incremental {mode} {k} against the full "
                       f"forward at block {blocks_run - 1}")
                for k in ("category", "attribute", "boxes"))
    return {"ms": ms, "blocks_run": blocks_run, "max_abs_err": worst,
            "launches": launches}


def _host_ms(fn, repeats=5):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_breakdown(name, model, codec, images):
    """Where one request of a path goes: the host-to-device copy of the
    images, the forward on the card, the text decode on the host, and the
    forward's kernels by device time (torch.profiler), with the shares of
    the stem kernel (K1) and the attention kernels (K3)."""
    from boosted_detr_torch.train import metrics
    from boosted_detr_torch.train.steps import make_predict_step

    step = make_predict_step(model)
    x = torch.from_numpy(images).cuda()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    kind = PATHS[name].get("serve", "text")
    out = step(x)
    row = {"h2d_ms": _host_ms(lambda: torch.from_numpy(images).cuda()),
           "forward_ms": _time_ms(lambda: step(x), flush), "decode_ms": None}
    post = "no host postprocess (class probabilities)"
    if kind != "classifier":
        raw = {k: v.cpu().numpy() for k, v in out.items()}

        def decode():
            codec.decode_predictions(raw)
            if kind == "panoptic":
                metrics.detr_panoptic_segments(raw)

        row["decode_ms"] = _host_ms(decode)
        what = ("text decode and panoptic segments" if kind == "panoptic"
                else "text decode")
        post = f"{what} {row['decode_ms']:.3f} ms (host clock)"
    _say(f"[breakdown {name}] one request of {BATCH}: H2D copy "
         f"{row['h2d_ms']:.3f} ms (host clock), forward "
         f"{row['forward_ms']:.3f} ms (CUDA events), {post}")
    n = 5
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    # one forward with the profiler tracing but not recording before the n
    # it records: a window that started recording cold has been seen to
    # miss its first kernels (K1's, one of ViT-p16's 40 blocks' K3)
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=activities,
                                schedule=schedule) as prof:
        step(x)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(n):
            step(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        _say("  profiler: no device time recorded; kernel breakdown not "
             "measured")
        return row
    row["device_busy_share"] = busy_us / wall_us
    row["device_busy_ms"] = busy_us / n / 1e3
    shares = []
    for key, tag in (("stem_kernel_ms", "patchify_fwd_"),
                     ("attention_ms", "attn_")):
        us = sum(e.self_device_time_total for e in kernels if tag in e.key)
        row[key] = us / n / 1e3
        shares.append(f"{row[key]:.3f} ms ({100 * us / busy_us:.1f}%)")
    _say(f"  profiler, {n} forwards: device busy {row['device_busy_ms']:.3f} "
         f"ms per forward, {100 * busy_us / wall_us:.1f}% of the wall time; "
         f"per forward the stem kernel (K1) {shares[0]}, the attention "
         f"kernels (K3) {shares[1]} of the busy time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        _say(f"    {e.self_device_time_total / n / 1e3:8.3f} ms "
             f"{100 * e.self_device_time_total / busy_us:5.1f}% "
             f"x{e.count // n:<4d} {e.key[:90]}")
    # the bf16 paths run the tensor-core forwards of K1 and K3 only, the
    # float32 ones the CUDA-core forwards
    ours = {}  # by name, the head dims of K3 together
    for e in kernels:
        if "patchify_fwd_" in e.key or "attn_fwd_" in e.key:
            kernel = re.search(r"(?:patchify|attn)_\w*?kernel", e.key)[0]
            ours[kernel] = ours.get(kernel, 0) + e.count // n
    _say(f"  forward kernels of K1 and K3 per forward: {ours}")
    dtype = PATHS[name]["cfg"].get("compute_dtype", "bfloat16")
    allowed = ({"patchify_fwd_kernel", "attn_fwd_kernel",
                "attn_fwd_wide_kernel"} if dtype == "float32" else
               {"patchify_fwd_mma_kernel", "attn_fwd_wgmma_kernel",
                "attn_fwd_wide_mma_kernel",
                "attn_fwd_wide_chunked_mma_kernel"})
    if not set(ours) <= allowed:
        raise AssertionError(f"a {dtype} forward ran a kernel of the other "
                             f"dtype's route: {ours}")
    _expect_forward_kernels(name, ours, "a forward", exact=True)
    row["forward_kernels"] = ours
    return row


def _expect_forward_kernels(name, ran, what, exact):
    """Raises unless the K3 forward kernels that ``what`` of path ``name``
    ran, {kernel: launches}, hold the path's ``fwd_kernels``: each as
    many times, or (not ``exact``: a long step's profile, which has been
    seen to drop kernels) each at least once."""
    want = PATHS[name].get("fwd_kernels", {})
    if any(ran.get(k, 0) < 1 or (exact and ran[k] != n)
           for k, n in want.items()):
        raise AssertionError(f"{name}: {what} ran the K3 forward kernels "
                             f"{ran}, expected {want}")


def _flagship_batch(cfg, batch_size, device):
    """The batch bench.py builds (bench.py:110-125): numpy seed 0, the same
    draws in the same order."""
    rng = np.random.default_rng(0)
    h, w = cfg.image_size
    batch = {
        "image": rng.uniform(0, 1, (batch_size, h, w, 3)).astype(np.float32),
        "category_ids": rng.integers(
            2, cfg.num_categories,
            (batch_size, cfg.max_objects)).astype(np.int32),
        "attribute_ids": rng.integers(
            0, cfg.num_attributes,
            (batch_size, cfg.max_objects, 4)).astype(np.int32),
        "bbox": rng.uniform(0.05, 0.45, (batch_size, cfg.max_objects,
                                         4)).astype(np.float32),
        "num_objects": rng.integers(1, cfg.max_objects + 1,
                                    (batch_size,)).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _path_batch(path, model, cfg, batch_size, device):
    """``_flagship_batch``, with ``masks`` from the boxes
    (``masks_from_boxes``) at the model's mask size for a panoptic path."""
    from boosted_detr_torch.models.panoptic import masks_from_boxes

    batch = _flagship_batch(cfg, batch_size, device)
    if path.get("builder") == "panoptic":
        batch["masks"] = masks_from_boxes(batch["bbox"], batch["num_objects"],
                                          model.mask_size)
    return batch


def _step_builder(path, model, cfg, tcfg):
    """The path's train step: ``make_train_step`` (detection),
    ``make_panoptic_train_step`` or ``make_pretrain_step``."""
    import boosted_detr_torch as bt

    builder = path.get("builder")
    if builder == "panoptic":
        return bt.make_panoptic_train_step(model, tcfg)
    if builder == "pretrain":
        return bt.make_pretrain_step(model)
    return bt.make_train_step(model, cfg, tcfg)


def _profile_split(prof, wall_us):
    """Device time of one profiled step by phase, and K3's share of it
    (``profile_step.attribute``: each kernel is anchored to the runtime
    call that launched it; a kernel under an autograd node is in the
    backward, any other in the ``record_function`` range of its phase)."""
    from boosted_detr_torch.benchmarks import profile_step

    rows = profile_step.attribute(prof.events())
    split = dict.fromkeys(profile_step.PHASES + ("other",), 0.0)
    for r in rows:
        split[r["phase"]] += r["us"] / 1e3
    attention_ms = sum(r["us"] for r in rows if "attn_" in r["name"]
                       or "tf32_split" in r["name"]) / 1e3
    return split, sum(split.values()), wall_us / 1e3, attention_ms


def _trained_stem(model):
    """The stem's parameters, {name: parameter}: those the K1 kernels
    (forward and dW) train where the stem is fused (the weight, and under
    ``skipinit`` the weight-standardised conv's ``gain``, whose gradient
    comes from K1-dW's through the standardisation), the plain stem conv's
    weight where it is not (the EfficientNets)."""
    backbone = getattr(model, "detr", model).backbone
    net = backbone.net
    conv = net.patch_embed if backbone.net_name == "vit" else net.stem.conv
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: p for p in (conv.weight, conv.gain)
            if p is not None}


def phase_training(name, warmup, steps):
    """One path's train step (bench.py:46-72, TrainConfig defaults) on the
    batch bench.py builds: warm-up steps, timed steps with the launch
    counters read around them, the checks, one profiled step, and one step
    from the same state with the plain versions of every kernel."""
    import boosted_detr_torch as bt

    path = PATHS[name]
    res = path["res"]
    cfg = _path_config(name, _codec())
    tcfg = bt.TrainConfig(batch_size=BATCH, **path.get("train", {}))
    torch.cuda.reset_peak_memory_stats()
    model = _build(path, cfg, seed=0)
    _randomize_skip_gains(model, seed=6)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != path.get("params", n_params):
        raise AssertionError(f"{name}: {n_params} parameters, the JAX model "
                             f"has {path['params']}")
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
    step = _step_builder(path, model, cfg, tcfg)
    batch = _path_batch(path, model, cfg, BATCH, model.device)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _say(f"[training {name}] {path.get('builder', 'detection')} train step "
         f"of {type(model).__name__}: batch "
         f"{BATCH} at {res}x{res}, backbone {cfg.backbone}, norm {cfg.norm}, "
         f"{n_params} parameters, fused attention "
         f"{cfg.use_pallas_attention}, {cfg.compute_dtype}, matcher "
         f"{cfg.matcher}, SGD "
         f"Nesterov {tcfg.momentum}, clipnorm {tcfg.clipnorm}, "
         f"{tcfg.lr_schedule}, intermediate losses "
         f"{tcfg.use_intermediate_losses}; {warmup} warm-up and {steps} "
         "timed steps")
    t0 = time.perf_counter()
    for i in range(warmup):
        with _lap_shapes() as shapes:
            state, _ = step(state, batch)
        if i == 0:
            _expect_lap_shapes(shapes, path, "the train step")
    torch.cuda.synchronize()
    _say(f"  warm-up: {time.perf_counter() - t0:.2f} s")

    _reset_launches()
    events, auxes = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, aux = step(state, batch)
        end.record()
        events.append((start, end))
        auxes.append(aux)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = _launches()
    _say(f"  kernel launches over {steps} steps: {launches}")
    want = {k: n * steps for k, n in path["step"].items()}
    if launches != want:
        raise AssertionError(f"expected {want}, got {launches}")
    step_ms = [a.elapsed_time(b) for a, b in events]
    for i, (ms, aux) in enumerate(zip(step_ms, auxes)):
        vals = {k: v.item() for k, v in aux.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: a loss is not finite: {vals}")
        _say(f"  step {i}: {ms:.3f} ms (CUDA events); " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(vals.items())))
    images_per_s = steps * BATCH / wall_s
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _say(f"  {images_per_s:.2f} images/s over {steps} steps (host "
         f"clock, {wall_s * 1e3 / steps:.3f} ms a step); median step "
         f"{statistics.median(step_ms):.3f} ms (CUDA events); peak device "
         f"memory allocated {peak_gb:.2f} GiB (parameters, gradients, "
         "momentum and a step's activations)")

    for pname, p in _trained_stem(model).items():
        g = p.grad
        if g is None or not torch.isfinite(g).all() or g.abs().sum() == 0:
            raise AssertionError(f"the stem's {pname} gradient is missing, "
                                 "not finite or zero")
        if torch.equal(p, before[pname]):
            raise AssertionError(f"the stem's {pname} did not move")
        _say(f"  stem {pname} gradient: finite, L2 norm "
             f"{g.norm().item():.4e} after the per-tensor clip; moved")
    after = model.state_dict()
    params = dict(model.named_parameters())
    if cfg.use_pallas_attention:
        # every query, key and value projection trains through K3's dq and
        # dk/dv (the key bias gets a zero gradient, see below)
        for pname, p in params.items():
            if pname.endswith(("query_projection.weight",
                               "key_projection.weight",
                               "value_projection.weight")):
                if p.grad is None or p.grad.abs().sum() == 0:
                    raise AssertionError(f"{pname}: no gradient through K3")
    still = [k for k in params if torch.equal(after[k], before[k])]
    stats = [k for k in after if "running" in k]
    still_stats = [k for k in stats if torch.equal(after[k], before[k])]
    _say(f"  changed: {len(params) - len(still)} of {len(params)} "
         f"parameters, {len(stats) - len(still_stats)} of {len(stats)} "
         f"running statistics; unchanged: {still + still_stats}; their "
         "last gradients' L2 norms: " + ", ".join(
             f"{params[k].grad.float().norm().item():.3e}"
             if params[k].grad is not None else "none" for k in still))
    may_stay = _ZERO_GRADIENT + path.get("may_stay", ())
    if still_stats or any(not k.endswith(may_stay)
                          or params[k].grad is None for k in still):
        raise AssertionError("a parameter or running statistic did not move")

    prof, wall_us = _profiled(lambda: step(state, batch))
    split, busy_ms, wall_ms, attention_ms = _profile_split(prof, wall_us)
    row = {"images_per_s": images_per_s, "step_ms": step_ms,
           "launches": launches, "peak_memory_gib": peak_gb}
    if busy_ms == 0:
        _say("  profiler: no device time recorded; split not measured")
    else:
        row.update(profile_split_ms=split, profile_busy_ms=busy_ms,
                   profile_wall_ms=wall_ms, profile_attention_ms=attention_ms,
                   device_busy_share=busy_ms / wall_ms)
        _say(f"  profiler, one step: wall {wall_ms:.3f} ms, device busy "
             f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%); by phase "
             "(device ms): " + ", ".join(f"{k.split('/')[-1]} {v:.3f}"
                                         for k, v in split.items())
             + f"; of which K3 (fwd, dq, dk/dv) {attention_ms:.3f} "
             f"({100 * attention_ms / busy_ms:.1f}%)")
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        row["profile_k1_dw_ms"] = sum(
            e.self_device_time_total for e in kernels
            if "patchify_dw" in e.key or "patchify_partials" in e.key) / 1e3
        row["profile_k1_fwd_ms"] = sum(
            e.self_device_time_total for e in kernels
            if "patchify_fwd" in e.key) / 1e3
        row["profile_k2_ms"] = sum(
            e.self_device_time_total for e in kernels
            if "lap_kernel" in e.key or "lap_columns_kernel" in e.key) / 1e3
        _say(f"  K1-fwd {row['profile_k1_fwd_ms']:.3f}, K1-dW (both passes) "
             f"{row['profile_k1_dw_ms']:.3f}, K2 {row['profile_k2_ms']:.3f} "
             "device ms of the step")
        if attention_ms:
            row["profile_k3_ms"] = {
                tag: sum(e.self_device_time_total for e in kernels
                         if f"attn_{tag}" in e.key) / 1e3
                for tag in ("fwd", "dq", "dkdv")}
            _say("  K3 by kernel (device ms): " + ", ".join(
                f"{k} {v:.3f}" for k, v in row["profile_k3_ms"].items()))
            fwd = {}  # the K3 forward kernels by name, the head dims together
            for e in kernels:
                if "attn_fwd_" in e.key:
                    kernel = re.search(r"attn_\w*?kernel", e.key)[0]
                    fwd[kernel] = fwd.get(kernel, 0) + e.count
            row["profile_k3_fwd_kernels"] = fwd
            _say(f"  K3 forward kernels a step: {fwd}")
            _expect_forward_kernels(name, fwd, "a train step", exact=False)
            # K3's gradient kernels by name, held to the path's
            # ``grad_kernels``: no other ran, and each at least once and
            # at most its count (a long step's profile has been seen to
            # drop kernels, never to add one); and every K3 kernel's
            # device ms, the TF32 route's split pass included
            grad, by_kernel = {}, {}
            for e in kernels:
                found = re.search(r"attn_\w*?kernel|tf32_split_kernel",
                                  e.key)
                if not found:
                    continue
                by_kernel[found[0]] = (by_kernel.get(found[0], 0)
                                       + e.self_device_time_total / 1e3)
                if "attn_dq" in e.key or "attn_dkdv" in e.key:
                    grad[found[0]] = grad.get(found[0], 0) + e.count
            row["profile_k3_grad_kernels"] = grad
            row["profile_k3_kernels_ms"] = by_kernel
            _say(f"  K3 gradient kernels a step: {grad}; K3 device ms by "
                 "kernel: " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in by_kernel.items()))
            want = path.get("grad_kernels")
            if want is not None and (set(grad) != set(want) or any(
                    not 1 <= grad[k] <= n for k, n in want.items())):
                raise AssertionError(f"{name}: a train step ran the K3 "
                                     f"gradient kernels {grad}, expected "
                                     f"{want}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
            _say(f"    {e.self_device_time_total / 1e3:8.3f} ms "
                 f"x{e.count:<4d} {e.key[:90]}")

    # One step from the same state three times: with the kernels, with the
    # plain versions of every kernel, and with the plain forward versions
    # but the backward kernels (K1-dW, K3-dq, K3-dkdv). The same dropout
    # bits (the step count seeds them), the same batch; the step is
    # otherwise deterministic. K2 gives its plain version's mask; K1-fwd,
    # K1-dW and K3 agree with theirs to one rounding of their results. The
    # losses differ where that rounding reaches them: held to 1e-3
    # relative, a few bf16 roundings of the activations.
    # K3-fwd's roundings, carried through the bf16 forward and live
    # BatchNorm, move the whole step's gradients by tens of percent (shown,
    # not held). With the forward the same, the backward is linear in the
    # cotangent, so the gradients of the third step are held against the
    # plain step's: all leaves together within 5e-2 of their L2 norm, and
    # each leaf a backward kernel writes (the stem weight, every query, key
    # and value projection weight) within 5e-2 of its own.
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    at = state.step

    def from_snapshot(plain):
        nonlocal state
        model.load_state_dict(snapshot)
        state.step = at
        with _plain_versions(plain), _gradients(state, params) as grads:
            state, aux = step(state, batch)
        return aux["loss"].item(), grads

    kernel_loss, kernel_grads = from_snapshot(())
    plain_loss, plain_grads = from_snapshot(tuple(KERNELS))
    _, backward_grads = from_snapshot(
        tuple(k for k in KERNELS if k not in _BACKWARD))
    rel = abs(kernel_loss - plain_loss) / abs(plain_loss)
    _say(f"  step {at} from one state: loss {kernel_loss:.6f} with the "
         f"kernels, {plain_loss:.6f} with the plain versions (relative "
         f"difference {rel:.3e}, held to 1e-3)")
    if not rel <= 1e-3:
        raise AssertionError("the kernel step's loss is off the plain one")
    if not kernel_grads.keys() == backward_grads.keys() == plain_grads.keys():
        raise AssertionError("the steps gave gradients to different "
                             "parameters")
    stem = _trained_stem(model)
    written = [k for k in plain_grads if k in stem or k.endswith((
        "query_projection.weight", "key_projection.weight",
        "value_projection.weight"))]
    leaf = {k: _norm_rel(backward_grads[k], plain_grads[k]) for k in written}
    worst = max(leaf, key=leaf.get)
    every = _norm_rel(torch.cat([g.flatten() for g in backward_grads.values()]),
                      torch.cat([g.flatten() for g in plain_grads.values()]))
    whole = _norm_rel(torch.cat([g.flatten() for g in kernel_grads.values()]),
                      torch.cat([g.flatten() for g in plain_grads.values()]))
    _say(f"  the same step's gradients, plain forward and backward kernels "
         f"against the plain versions: all {len(plain_grads)} leaves "
         f"{every:.3e} of their L2 norm, the worst of the {len(leaf)} leaves "
         f"the backward kernels write {worst} {leaf[worst]:.3e} (each held "
         f"to 5e-2); the kernel step's against the plain step's {whole:.3e} "
         f"(not held)")
    if not (every <= 5e-2 and leaf[worst] <= 5e-2):
        raise AssertionError("the backward kernels' gradients are off the "
                             "plain ones")
    row.update(loss_rel_diff_plain=rel, grad_rel_diff_backward=every,
               grad_rel_diff_backward_worst_leaf=leaf[worst],
               grad_rel_diff_step=whole)
    if "train_block" in path:
        model.load_state_dict(snapshot)
        staged = phase_staged(name, model, cfg, tcfg, batch, at)
        row.update(staged)
        row["launches"] = {k: v + staged["staged_launches"][k]
                           for k, v in launches.items()}
        _say(f"  staged step {staged['staged_step_ms_median']:.3f} ms "
             f"against the joint step's {statistics.median(step_ms):.3f} ms "
             f"(medians, CUDA events)")
    return row


def _profiled(fn):
    """One call of ``fn`` under torch.profiler: (the profile, its wall
    time in us)."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


@contextlib.contextmanager
def _lap_masks():
    """The assignment masks the matching loss's solver returns while the
    block runs, on the host."""
    from boosted_detr_torch.ops import matching as M

    solve = M.solve_matching
    masks = []

    def spy(cost, num_objects, method="hungarian"):
        mask = solve(cost, num_objects, method)
        masks.append(mask.detach().cpu())
        return mask

    M.solve_matching = spy
    try:
        yield masks
    finally:
        M.solve_matching = solve


@contextlib.contextmanager
def _lap_shapes():
    """The shapes of the cost tensors the matching loss hands to its
    solver (K2 on the card) while the block runs."""
    from boosted_detr_torch.ops import matching as M

    solve = M.solve_matching
    shapes = []

    def spy(cost, num_objects, method="hungarian"):
        shapes.append(tuple(cost.shape))
        return solve(cost, num_objects, method)

    M.solve_matching = spy
    try:
        yield shapes
    finally:
        M.solve_matching = solve


def _expect_lap_shapes(shapes, path, what, key="lap_shape"):
    _say(f"  {what}: K2 problem {shapes}")
    if key in path and shapes != [path[key]]:
        raise AssertionError(f"{what}: expected one K2 launch at "
                             f"{path[key]}, got {shapes}")


def phase_staged(name, model, cfg, tcfg, batch, at):
    """Staged training from the joint steps' state: the optimizer holds
    weak learner ``k``'s leaves and ``decoder_prep`` alone
    (``boosted_block_mask``), the forward stops at block k and the loss is
    its own (``train_block`` with intermediate losses). A warm-up step,
    STAGED_STEPS timed steps counted (K1-dW never: the backbone is frozen
    and gets no gradient; K2 at [8, 32, 96]) and one profiled step; then
    every frozen parameter is held bit for bit and block k's must have
    moved."""
    import boosted_detr_torch as bt

    path = PATHS[name]
    k = path["train_block"]
    staged_cfg = tcfg.replace(train_block=k)
    mask = bt.boosted_block_mask(model, k)
    state = bt.TrainState.create(model, bt.make_optimizer(
        staged_cfg, model.named_parameters(), d_model=cfg.decoder_dim,
        trainable_mask=mask))
    state.step = at
    step = bt.make_train_step(model, cfg, staged_cfg)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _say(f"[staged {name}] train_block={k}: {sum(mask.values())} of "
         f"{len(mask)} parameters train (weak learner {k} and "
         "decoder_prep); 1 warm-up step, "
         f"{STAGED_STEPS} timed steps")
    with _lap_shapes() as shapes:
        state, _ = step(state, batch)
    _expect_lap_shapes(shapes, {"lap_shape": (BATCH, 32, 96)},
                       "the staged step")
    events = []

    def timed():
        nonlocal state
        for _ in range(STAGED_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, aux = step(state, batch)
            end.record()
            events.append((start, end, aux))

    want = {n: c * STAGED_STEPS for n, c in path["staged"].items()}
    _, _, launches = _counted(timed, want, "staged steps")
    step_ms = [a.elapsed_time(b) for a, b, _ in events]
    for i, (ms, (_, _, aux)) in enumerate(zip(step_ms, events)):
        vals = {key: v.item() for key, v in aux.items()}
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"staged step {i}: a loss is not finite")
        _say(f"  staged step {i}: {ms:.3f} ms (CUDA events); loss "
             f"{vals['loss']:.4f}")
    _say(f"  kernel launches over {STAGED_STEPS} staged steps: {launches}")
    frozen = [n for n in mask if not mask[n]]
    changed = [n for n in frozen
               if not torch.equal(model.get_parameter(n), before[n])]
    graded = [n for n in frozen if model.get_parameter(n).grad is not None]
    trained = [n for n in mask if mask[n]]
    still = [n for n in trained
             if torch.equal(model.get_parameter(n), before[n])
             and not n.endswith(_ZERO_GRADIENT + path.get("may_stay", ()))]
    _say(f"  frozen parameters: {len(frozen)}, {len(changed)} changed, "
         f"{len(graded)} with a gradient; trained: {len(trained)}, "
         f"{len(still)} unchanged")
    if changed or graded or still:
        raise AssertionError(f"staged step: frozen changed {changed[:4]}, "
                             f"frozen with a gradient {graded[:4]}, trained "
                             f"unchanged {still[:4]}")
    prof, wall_us = _profiled(lambda: step(state, batch))
    split, busy_ms, wall_ms, _ = _profile_split(prof, wall_us)
    row = {"staged_step_ms": step_ms,
           "staged_step_ms_median": statistics.median(step_ms),
           "staged_launches": launches}
    if busy_ms:
        row.update(staged_profile_split_ms=split,
                   staged_profile_busy_ms=busy_ms,
                   staged_profile_wall_ms=wall_ms)
        _say(f"  profiler, one staged step: wall {wall_ms:.3f} ms, device "
             f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%); by "
             "phase (device ms): " + ", ".join(
                 f"{key.split('/')[-1]} {v:.3f}" for key, v in split.items()))
    else:
        _say("  profiler: no device time recorded; split not measured")
    return row


def _small_configs():
    """The small float32 models, {label: (path-style entry, config,
    TrainConfig keywords)}: the ResNet DETR of the CPU tests, the same with
    the fused
    attention (2 heads of 32: K3's head dims), a ViT DETR (patch 16, width
    64, 2 blocks of 2 heads), a boosted ensemble with carried queries and
    the fused attention; and one for each other backbone and norm: an
    EfficientNet-lite DETR, a narrow B4 DETR (width 0.25: 1.4 x 0.25 of
    B4's widths, stochastic depth on), a tiny DETR with GroupNorm, a conv7
    ResNet DETR, and a norm-free ResNet DETR (K1 on standardised weights)
    trained with the adaptive gradient clip; a DETRPanoptic (mask size 32)
    trained with its panoptic step, a DETRMultiClassifier (12 classes)
    trained with its pre-train step, and the ResNet DETR with the
    ``auction`` and with the ``greedy`` matcher."""
    import boosted_detr_torch as bt

    resnet = bt.ModelConfig(image_size=(64, 64), backbone="resnet",
                            backbone_width=0.25, stem="patchify8",
                            use_pallas_stem=True, compute_dtype="float32",
                            num_encoder_blocks=2, num_decoder_blocks=2,
                            encoder_dim=64, decoder_dim=64,
                            num_object_preds=16, num_categories=12,
                            num_attributes=20, max_objects=8,
                            matcher="pallas", dropout_rate=0.0)
    fused = resnet.replace(use_pallas_attention=True, num_encoder_heads=2,
                           num_decoder_heads=2)
    detr, boosted = {}, dict(model="BoostedDETR")
    panoptic = dict(model="DETRPanoptic", builder="panoptic",
                    model_kw=lambda cfg: dict(mask_size=32))
    pretrainer = dict(model="DETRMultiClassifier", builder="pretrain",
                      serve="classifier", model_kw=lambda cfg: dict(
                          num_classifier_classes=cfg.num_categories))
    return {"DETR": (detr, resnet, {}),
            "DETR, fused attention": (detr, fused, {}),
            "ViT DETR, fused attention": (detr, fused.replace(
                backbone="vit_p16_d2_w64_h2", backbone_width=1.0), {}),
            "BoostedDETR, carried queries, fused attention": (
                boosted, fused.replace(boosted_queries="carry"), {}),
            "EfficientNet-lite DETR": (detr, resnet.replace(
                backbone="efficientnet_lite"), {}),
            "EfficientNet-B4 DETR, width 0.25": (detr, resnet.replace(
                backbone="efficientnet_b4"), {}),
            "tiny DETR, GroupNorm": (detr, resnet.replace(
                backbone="tiny", norm="groupnorm"), {}),
            "ResNet conv7 DETR": (detr, resnet.replace(
                stem="conv7", use_pallas_stem=False), {}),
            "skipinit DETR, AGC 0.05": (detr, resnet.replace(
                norm="skipinit"), dict(agc_clip=0.05)),
            "DETRPanoptic, mask size 32": (panoptic, resnet, {}),
            "DETRMultiClassifier, 12 classes": (pretrainer, resnet, {}),
            "DETR, auction matcher": (detr, resnet.replace(
                matcher="auction"), {}),
            "DETR, greedy matcher": (detr, resnet.replace(
                matcher="greedy"), {})}


def phase_small_reference(label, path, cfg, train_kw):
    """A small float32 model on the card against the same weights on the
    CPU, where the port runs the plain versions that the CPU tests hold
    against the JAX package. ``path`` names the model, its keywords, its
    step builder and how it serves, as an entry of PATHS does."""
    import boosted_detr_torch as bt

    cpu = _build(path, cfg, device="cpu", seed=2)
    _randomize_running_stats(cpu, seed=3)
    _randomize_skip_gains(cpu, seed=7)
    gpu = _build(path, cfg, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    images = np.random.default_rng(4).uniform(
        -0.05, 1.05, (2, 64, 64, 3)).astype(np.float32)
    want = _raw(path, cpu, images)
    got = _raw(path, gpu, images)
    _say(f"[small reference] float32 {label} 64x64, card against CPU")
    # float32 throughout: the sums run in another order (cuDNN, cuBLAS and
    # the kernel against oneDNN), ~1e-6 at this size; 1e-4 leaves room.
    for key in sorted(want):
        _close(torch.from_numpy(got[key]), torch.from_numpy(want[key]),
               atol=1e-4, rtol=1e-4, what=key)

    # One train step from the same weights and batch: the card through the
    # kernels (stem forward and dW, K2, K3 where the attention is fused),
    # the CPU through the plain versions.
    # Dropout is 0 (the CPU and the card draw different bits); the B4's
    # stochastic depth draws its bits from one CPU generator, seeded alike
    # for both sides (the backbone draws on the generator's device). With
    # live batch statistics this model amplifies float32 rounding ~2000x at
    # batch 8 (tests/test_torch_train.py), and cuDNN and oneDNN round
    # differently: losses are held to 1e-4 relative, the new parameters to
    # 2e-5 absolute (a tenth of the largest single-value update, lr 1e-3 x
    # 1.9 x the 0.1 clip), the running statistics to 1e-4.
    tcfg = bt.TrainConfig(batch_size=8, **train_kw)
    batches = {dev: _path_batch(path, cpu, cfg, 8, dev)
               for dev in ("cpu", "cuda")}
    results = {}
    for dev, model in (("cpu", cpu), ("cuda", gpu)):
        state = bt.TrainState.create(model, bt.make_optimizer(
            tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
        _, aux = _step_builder(path, model, cfg, tcfg)(
            state, batches[dev], torch.Generator().manual_seed(5))
        results[dev] = ({k: v.item() for k, v in aux.items()},
                        {k: v.cpu() for k, v in model.state_dict().items()})
    (want_aux, want_state), (got_aux, got_state) = results["cpu"], results[
        "cuda"]
    worst = max(abs(got_aux[k] - want_aux[k]) / max(abs(want_aux[k]), 1e-6)
                for k in want_aux)
    _say(f"  train step: losses within {worst:.3e} relative (held to 1e-4)")
    if worst > 1e-4:
        raise AssertionError(f"train-step losses differ: {got_aux} against "
                             f"{want_aux}")
    params = {k: v for k, v in want_state.items() if "running" not in k}
    stats = {k: v for k, v in want_state.items() if "running" in k}
    p_err = max((got_state[k] - v).abs().max().item()
                for k, v in params.items())
    s_err = max((((got_state[k] - v).abs() / v.abs().clamp_min(1e-2)).max()
                 .item() for k, v in stats.items()), default=0.0)
    _say(f"  train step: new parameters within {p_err:.3e} (held to 2e-5), "
         f"running statistics ({len(stats)}) within {s_err:.3e} relative "
         "(held to 1e-4)")
    if p_err > 2e-5 or s_err > 1e-4:
        raise AssertionError("the train step's state differs between the "
                             "card and the CPU")


# The trainer phase: the training loop as users run it, on the 640
# flagship's config. Host-fed: SyntheticShapes' hard preset -> Pipeline ->
# prefetch_to_device -> Trainer.fit with augment_batch on the card as its
# batch_fn, validation and a CSV log; device-fed: make_batch_fn renders
# each batch on the card.
TRAINER_IMAGES, TRAINER_VAL_IMAGES = 24, 16
TRAINER_EPOCHS, TRAINER_STEPS = 2, 3  # steps_per_epoch
DEVICE_FED_STEPS = 3


def _synthetic_codec():
    """The flagship's vocabulary sizes (80 categories, 294 attributes, each
    list with <PAD> and <OOV>: 28,824,190 parameters) with SyntheticShapes'
    words first, so that its colors are categories 2-7 and its size and
    aspect words attributes 2-6, as the device renderer numbers them; the
    rest are COCO's categories and Fashionpedia's attributes."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.data import vocabularies
    from boosted_detr_torch.data.codec import TextCodec

    own = bt.SyntheticShapes().get_vocab()
    full = {"category": vocabularies.vocab_dict("COCO")["category"],
            "attribute": vocabularies.vocab_dict("Fashionpedia")["attribute"]}
    vocab = {k: own[k] + [w for w in full[k] if w not in own[k]][
        :len(full[k]) - len(own[k])] for k in full}
    return TextCodec(vocab)


class _Rows:
    """The rows of a split where pandas is missing: ``Pipeline.batches``
    reads a frame through ``to_dict("records")`` alone."""

    def __init__(self, rows):
        self._rows = rows

    def to_dict(self, orient):
        if orient != "records":
            raise ValueError(orient)
        return [dict(r) for r in self._rows]


def _frames(ds):
    """(train, val) frames of ``ds``, through pandas where it is installed,
    else the same rows through ``_Rows``; and which of the two."""
    try:
        import pandas  # noqa: F401
    except ImportError:
        return _Rows(ds.rows("train")), _Rows(ds.rows("val")), "rows"
    return ds.dataframes("train"), ds.dataframes("val"), "pandas"


def _same_state(a, b, what):
    """Raises unless two train states are equal bit for bit: the step, the
    optimizer's count and momentum, every parameter and buffer (BatchNorm's
    running statistics included) and the EMA shadow."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    oa, ob = a.optimizer.inner.state_dict(), b.optimizer.inner.state_dict()
    bad += [f"momentum {i}" for i in oa["state"]
            if not all(torch.equal(v, ob["state"][i][k])
                       for k, v in oa["state"][i].items())]
    if (a.step, a.optimizer.count) != (b.step, b.optimizer.count):
        bad.append(f"step {a.step}/{b.step}, count "
                   f"{a.optimizer.count}/{b.optimizer.count}")
    _say(f"  {what}: {len(sa)} entries and {len(oa['state'])} momentum "
         f"buffers, {len(bad)} differ")
    if bad:
        raise AssertionError(f"{what}: {bad[:8]}")


def _timed_steps(trainer):
    """Wraps the trainer's step: the host clock at each step's start (the
    intervals between starts hold the feed, the step and its loss
    read-back) and, checked on each call, that every batch tensor lies on
    the card."""
    starts = []
    step = trainer._train_step

    def timed(state, batch):
        starts.append(time.perf_counter())
        off = [k for k, v in batch.items() if not v.is_cuda]
        if off:
            raise AssertionError(f"batch entries off the card: {off}")
        return step(state, batch)

    trainer._train_step = timed
    return starts


def _step_intervals(starts, per_epoch):
    """Milliseconds between successive step starts within each epoch."""
    out = []
    for e in range(0, len(starts), per_epoch):
        chunk = starts[e:e + per_epoch]
        out += [(b - a) * 1e3 for a, b in zip(chunk, chunk[1:])]
    return out


def _busy_share(fn):
    prof, wall_us = _profiled(fn)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation)
    return busy_us / 1e3, wall_us / 1e3


def phase_trainer():
    """The port's training loop through its user entry points on the 640
    flagship's config (PATHS["flagship"], 28,824,190 parameters, batch 8,
    bf16, 32 objects, K1 on, K2 exact, K3 off), with the gates of the
    trainer path: launches per fit step, eval step and predict forward;
    the Trainer's step against make_train_step's; scan_steps; save and
    restore; rasterize and the augmentations on the card against the CPU;
    prefetched batches against the iterator's; the NaN guard; evaluate,
    predict and evaluate_map. Reports the fit step's time on the host-fed
    and the device-fed routes, the device-busy share of one profiled fit
    step on each, the pinned and pageable copies of one batch, and the
    time to render one batch on the card."""
    import tempfile

    import boosted_detr_torch as bt
    from boosted_detr_torch.data import augment, device_synth
    from boosted_detr_torch.train import metrics

    path = PATHS["flagship"]
    codec = _synthetic_codec()
    cfg = _path_config("flagship", codec)
    row = {}
    ds = bt.SyntheticShapes.hard(num_images=TRAINER_IMAGES, image_size=RES,
                                 num_val_images=TRAINER_VAL_IMAGES)
    train_rows, val_rows, source = _frames(ds)
    how = ("a pandas DataFrame" if source == "pandas" else
           "a list of dicts behind to_dict (pandas is not installed here)")
    _say(f"[trainer] SyntheticShapes.hard({TRAINER_IMAGES} images, "
         f"{TRAINER_VAL_IMAGES} val) at {RES}x{RES}; rows through {how}")
    row["rows_from"] = source
    pipe = bt.Pipeline((RES, RES), cfg.max_objects, codec, dataset=ds)
    host = list(pipe.batches(train_rows, BATCH, epoch=0))
    val = list(pipe.batches(val_rows, BATCH, shuffle=False))

    def model_of(seed):
        model = _build(path, cfg, seed=seed)
        n = sum(p.numel() for p in model.parameters())
        if n != 28_824_190:
            raise AssertionError(f"{n} parameters, not the flagship's")
        return model

    def trainer_of(seed, **train_kw):
        tcfg = bt.TrainConfig(batch_size=BATCH, **train_kw)
        return bt.Trainer(model_of(seed), cfg, tcfg, codec=codec).compile()

    # gate 7: prefetch_to_device yields the iterator's batches bit for bit
    got = list(bt.prefetch_to_device(iter(host), size=2))
    for i, (g, w) in enumerate(zip(got, host)):
        for k, v in w.items():
            if v.dtype.kind in "biuf" and not torch.equal(
                    g[k].cpu(), torch.from_numpy(v)):
                raise AssertionError(f"prefetched batch {i} {k} differs")
    if len(got) != len(host):
        raise AssertionError(f"{len(got)} prefetched of {len(host)}")
    _say(f"  prefetch_to_device: {len(got)} batches equal to the "
         "iterator's bit for bit (pinned, side stream)")
    image = host[0]["image"]
    pinned = torch.from_numpy(image).pin_memory()
    row["h2d_pageable_ms"] = _host_ms(lambda: torch.from_numpy(image).cuda())
    row["h2d_pinned_ms"] = _host_ms(lambda: pinned.cuda(non_blocking=True))
    _say(f"  H2D copy of one batch's images ({image.nbytes} bytes): "
         f"pageable {row['h2d_pageable_ms']:.3f} ms, pinned "
         f"{row['h2d_pinned_ms']:.3f} ms (host clock, medians of 5)")

    # gate 5: rasterize on the card equals the CPU's for one scene
    gen = torch.Generator().manual_seed(21)
    scenes = [device_synth.sample_scene(gen, 8, 2, (0.04, 0.6),
                                        cfg.max_objects)
              for _ in range(BATCH)]
    scene = {k: torch.stack([sc[k] for sc in scenes]) for k in scenes[0]}
    bg = torch.stack([device_synth.draw_background(gen, RES)
                      for _ in range(BATCH)])
    want = device_synth.rasterize(bg, scene, RES)
    got = device_synth.rasterize(bg.cuda(), {k: v.cuda() for k, v in
                                             scene.items()}, RES).cpu()
    if not torch.equal(got, want):
        raise AssertionError("rasterize on the card differs from the CPU's")
    _say(f"  rasterize: {BATCH} scenes of {cfg.max_objects} slots at {RES}, "
         "the card's equal to the CPU's bit for bit")

    # gate 6: the pure augmentations with the same draws, card against CPU
    draws = augment.draw_augmentations(torch.Generator().manual_seed(22),
                                       BATCH)
    cpu_batch = {k: torch.from_numpy(host[0][k]) for k in ("image", "bbox")}
    cpu_batch["masks"] = device_synth.scene_masks(scene, MASK_SIZE)
    want = augment.apply_augmentations(cpu_batch, draws)
    got = augment.apply_augmentations(
        {k: v.cuda() for k, v in cpu_batch.items()},
        {k: v.cuda() for k, v in draws.items()})
    for k in ("image", "bbox", "masks"):
        _close(got[k], want[k], atol=1e-6, rtol=0.0,
               what=f"augmentation {k}, card against CPU, same draws")

    # gate 2: the Trainer's first step is make_train_step's, bit for bit
    b0 = {k: v for k, v in host[0].items() if k in bt.Trainer.BATCH_KEYS}
    single = trainer_of(0)
    loss = single.fit([b0])["loss"][0]
    model = model_of(0)
    tcfg = bt.TrainConfig(batch_size=BATCH)
    direct = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
    direct, aux = bt.make_train_step(model, cfg, tcfg)(
        direct, {k: torch.from_numpy(v).cuda() for k, v in b0.items()})
    _say(f"  the Trainer's first step: loss {loss!r}, make_train_step's "
         f"{aux['loss'].item()!r}")
    if loss != aux["loss"].item():
        raise AssertionError("the Trainer's step loss differs")
    _same_state(single.state, direct, "the Trainer's step against "
                "make_train_step's")
    del model, direct

    # gate 3: scan_steps=2 equals scan_steps=1 over 2 steps
    b1 = {k: v for k, v in host[1].items() if k in bt.Trainer.BATCH_KEYS}
    grouped = trainer_of(0)
    h2 = grouped.fit([b0, b1], scan_steps=2)
    h1 = single.fit([b1])  # single has taken b0 already
    # the epoch's mean loss, summed in the same order as fit sums it
    _say(f"  scan_steps=2: epoch loss {h2['loss'][0]!r}; scan_steps=1: "
         f"{(loss + h1['loss'][0]) / 2!r}")
    if h2["loss"][0] != (loss + h1["loss"][0]) / 2:
        raise AssertionError(f"scan_steps: losses {h2} against {loss}, {h1}")
    _same_state(grouped.state, single.state, "scan_steps=2 against 1")

    # gate 8: a batch whose image holds a NaN raises NaNLossError
    bad = dict(b1, image=b1["image"].copy())
    bad["image"][0, 0, 0, 0] = np.nan
    try:
        grouped.fit([bad])
    except bt.NaNLossError as exc:
        _say(f"  NaN guard: NaNLossError ({exc})")
    else:
        raise AssertionError("a NaN image did not raise NaNLossError")
    del grouped, single
    torch.cuda.empty_cache()

    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn):
        _reset_launches()
        out = fn()
        got = _launches()
        for k, v in got.items():
            launches[k] += v
        return out, got

    with tempfile.TemporaryDirectory() as tmp:
        # the host-fed route, with checkpoints every epoch
        ckpt = os.path.join(tmp, "checkpoints")
        trainer = trainer_of(0, checkpoint_dir=ckpt, keep_checkpoints=2)
        aug = torch.Generator(device="cuda").manual_seed(23)
        starts = _timed_steps(trainer)
        log = os.path.join(tmp, "fit.csv")
        t0 = time.perf_counter()
        history, got = counted(lambda: trainer.fit(
            lambda: bt.prefetch_to_device(pipe.batches(train_rows, BATCH)),
            epochs=TRAINER_EPOCHS, steps_per_epoch=TRAINER_STEPS,
            batch_fn=lambda b: augment.augment_batch(aug, b),
            validation_batches=lambda: pipe.batches(val_rows, BATCH,
                                                    shuffle=False),
            log_path=log, log_every=1))
        fit_s = time.perf_counter() - t0
        steps = TRAINER_EPOCHS * TRAINER_STEPS
        evals = TRAINER_EPOCHS * len(val)
        want = {k: steps * path["step"][k] + evals * (k in ("patchify_fwd",
                                                            "lap"))
                for k in KERNELS}
        _say(f"  host-fed fit, {TRAINER_EPOCHS} epochs of {TRAINER_STEPS} "
             f"steps and {len(val)} validation batches: {fit_s:.2f} s; "
             f"losses {history['loss']}, val {history['val_loss']}; "
             f"launches {got} (expected {want})")
        if got != want:
            raise AssertionError("host-fed fit: launch counts")
        if not np.all(np.isfinite(history["loss"] + history["val_loss"])):
            raise AssertionError(f"host-fed fit: {history}")
        with open(log) as f:
            logged = sum(1 for _ in f) - 1
        if logged != steps:
            raise AssertionError(f"{logged} CSV rows for {steps} steps")
        row["host_fed_step_ms"] = _step_intervals(starts, TRAINER_STEPS)
        _say(f"  host-fed fit step (host clock between step starts: the "
             f"feed, the step and its loss read-back): "
             f"{row['host_fed_step_ms']} ms, median "
             f"{statistics.median(row['host_fed_step_ms']):.3f}")

        # gate 4: a new Trainer whose compile restores equals this one, and
        # one further step from each is equal
        restored = trainer_of(1, checkpoint_dir=ckpt, keep_checkpoints=2)
        _say(f"  checkpoints {sorted(os.listdir(ckpt))}; restored at step "
             f"{restored.state.step}")
        _same_state(restored.state, trainer.state, "restored against saved")
        restored.fit([b0])
        trainer.fit([b0])
        _same_state(restored.state, trainer.state, "one step further")
        del restored

        # gate 9: evaluate, predict and evaluate_map through the Trainer
        ev, got = counted(lambda: trainer.evaluate(val))
        _say(f"  evaluate over {len(val)} batches: {ev}; launches {got}")
        if not np.isfinite(ev["loss"]) or got != _expect(
                patchify_fwd=len(val), lap=len(val)):
            raise AssertionError("evaluate")
        (cats, atts, boxes), got = counted(
            lambda: trainer.predict(val[0]["image"]))
        words = set(codec.category_vocab)
        _say(f"  predict: {len(cats)} images decoded, first "
             f"{list(cats[0][:4])}; launches {got}")
        if (len(cats) != BATCH or got != path["forward"]
                or not all(c in words for c in np.asarray(cats).ravel())
                or not np.isfinite(boxes).all()):
            raise AssertionError("predict")
        result, got = counted(lambda: metrics.evaluate_map(trainer, val))
        _say(f"  evaluate_map: mAP {result['mAP']!r}, mAP50 "
             f"{result['mAP50']!r}; launches {got}")
        if not np.isfinite(result["mAP"]) or got != _expect(
                patchify_fwd=len(val)):
            raise AssertionError("evaluate_map")
        # one profiled fit step, its feed included
        busy, wall = _busy_share(lambda: trainer.fit(
            lambda: bt.prefetch_to_device(pipe.batches(train_rows, BATCH)),
            steps_per_epoch=1,
            batch_fn=lambda b: augment.augment_batch(aug, b)))
        row["host_fed_busy_share"] = busy / wall
        _say(f"  profiled host-fed fit step: wall {wall:.3f} ms, device "
             f"busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
        del trainer
        torch.cuda.empty_cache()

    # the device-fed route: batches rendered on the card
    render = bt.make_batch_fn(RES, BATCH, cfg.max_objects, pool_size=None)
    row["render_ms"] = _host_ms(lambda: render(100))
    _say(f"  make_batch_fn: one batch of {BATCH} at {RES} rendered on the "
         f"card in {row['render_ms']:.3f} ms (host clock, median of 5)")
    trainer = trainer_of(0)
    # one step first, outside the count and the clock: the memory the
    # earlier models freed is allocated again there
    trainer.fit(range(1), batch_fn=render)
    starts = _timed_steps(trainer)
    history, got = counted(lambda: trainer.fit(
        range(1, 1 + DEVICE_FED_STEPS), batch_fn=render))
    want = {k: DEVICE_FED_STEPS * n for k, n in path["step"].items()}
    _say(f"  device-fed fit, {DEVICE_FED_STEPS} steps: loss "
         f"{history['loss']}; launches {got} (expected {want})")
    if got != want or not np.isfinite(history["loss"]).all():
        raise AssertionError("device-fed fit")
    row["device_fed_step_ms"] = _step_intervals(starts, DEVICE_FED_STEPS)
    _say(f"  device-fed fit step: {row['device_fed_step_ms']} ms, median "
         f"{statistics.median(row['device_fed_step_ms']):.3f}")
    busy, wall = _busy_share(lambda: trainer.fit(range(1), batch_fn=render))
    row["device_fed_busy_share"] = busy / wall
    _say(f"  profiled device-fed fit step: wall {wall:.3f} ms, device busy "
         f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
    row["launches"] = launches
    _say(f"  trainer phase launches (host- and device-fed fit, evaluate, "
         f"predict, evaluate_map): {launches}")
    return row


API_FIT_STEPS = 3
CLI_IMAGES = 16  # two CLI train steps of 8
FLAGSHIP_PARAMS = 28_824_190


def _api_kw(name, codec):
    """A path's ModelConfig as the user API's keywords (the API takes the
    vocabulary sizes from its codec)."""
    return {k: v for k, v in dataclasses.asdict(_path_config(
        name, codec)).items() if k not in ("num_categories", "num_attributes")}


def _same_weights(a, b, what):
    sa, sb = a.state_dict(), b.state_dict()
    bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
    _say(f"  {what}: {len(sa)} entries (weights and running statistics), "
         f"{len(bad)} differ")
    if bad or sa.keys() != sb.keys():
        raise AssertionError(f"{what}: {bad[:8]}")


def _held(got, want, what, atol=5e-2):
    """Each raw output of an artifact against the live model's, at the
    serving phases' gate; returns the largest difference."""
    worst = 0.0
    for k in want:
        worst = max(worst, _close(torch.from_numpy(np.asarray(got[k],
                                                              np.float32)),
                                  torch.from_numpy(np.asarray(want[k],
                                                              np.float32)),
                                  atol=atol, rtol=0.0, what=f"{what} {k}"))
    return worst


def _middle(values):
    """A threshold in the widest gap between per-image values (clear of
    rounding), so that some images fall on each side."""
    v = np.sort(np.asarray(values, np.float64))
    i = int(np.argmax(np.diff(v)))
    return float(v[i] + (v[i + 1] - v[i]) / 2)


def phase_api_serving():
    """The user path through the port's front door on the 640 flagship's
    config: ``api.DETR`` built, compiled and fitted on SyntheticShapes.hard
    frames, ``save`` and ``load_model`` (bit for bit), ``export_serving``
    and ``load_serving``, requests to the artifact (K1-fwd counted in it;
    outputs and text against the live model); ``api.BoostedDETR``
    early-exit artifacts in both criteria and an EMA artifact; a ViT-p16
    artifact with K3 in it; and the CLI's train, evaluate and export in
    this process. Reports each export's seconds and size and an artifact
    request's host time beside the live request's."""
    import tempfile

    import boosted_detr_torch as bt
    from boosted_detr_torch import api, cli, serving
    from boosted_detr_torch.models import early_exit
    from boosted_detr_torch.train.steps import make_predict_step

    codec = _synthetic_codec()
    vocab = codec.vocab_dict
    row = {"export_s": {}, "pt2_bytes": {}}
    launches = dict.fromkeys(KERNELS, 0)

    def counted(fn, want, what):
        out, ms, got = _counted(fn, want, what)
        for k, v in got.items():
            launches[k] += v
        return out, ms

    def export(trainer, path, label, **kw):
        t0 = time.perf_counter()
        serving.export_serving(trainer, path, **kw)
        row["export_s"][label] = time.perf_counter() - t0
        row["pt2_bytes"][label] = os.path.getsize(os.path.join(
            path, serving.PROGRAM))
        _say(f"  export {label}: {row['export_s'][label]:.2f} s, "
             f"model.pt2 {row['pt2_bytes'][label]} bytes")
        return serving.load_serving(path)

    ds = bt.SyntheticShapes.hard(num_images=API_FIT_STEPS * BATCH,
                                 image_size=RES, num_val_images=BATCH)
    train_rows, val_rows, _ = _frames(ds)
    tmp = tempfile.mkdtemp(prefix="api_serving_")
    try:
        # 1. build, compile, fit
        model = api.DETR(vocab_dict=vocab, **_api_kw("flagship", codec))
        n = sum(p.numel() for p in model.module.parameters())
        if n != FLAGSHIP_PARAMS:
            raise AssertionError(f"{n} parameters, not the flagship's")
        pipe = model.make_pipeline(dataset=ds)
        batches = list(pipe.batches(train_rows, BATCH, epoch=0))
        images = [b["image"] for b in pipe.batches(val_rows, BATCH,
                                                   shuffle=False)]
        requests = (images * REQUESTS)[:REQUESTS]
        model.compile(sample_batch=batches[0],
                      train_config=bt.TrainConfig(batch_size=BATCH))
        step = PATHS["flagship"]["step"]
        history, ms = counted(lambda: model.fit(batches),
                              {k: API_FIT_STEPS * v for k, v in step.items()},
                              "api.DETR.fit")
        _say(f"[api_serving] api.DETR ({n} parameters) fit {API_FIT_STEPS} "
             f"steps in {ms:.1f} ms: loss {history['loss']}")
        if not np.isfinite(history["loss"]).all():
            raise AssertionError("api fit: a loss is not finite")

        # 2. save and load_model: bit for bit
        saved = os.path.join(tmp, "saved")
        model.save(saved)
        loaded = api.load_model(saved)
        _same_weights(loaded.module, model.module, "load_model against save")
        del model
        torch.cuda.empty_cache()

        # 3. the artifact: K1 once a request, outputs and text as the live
        # model's
        served = export(loaded.trainer, os.path.join(tmp, "flagship"),
                        "flagship")
        if served.meta["platforms"] != ["cuda"]:
            raise AssertionError(f"meta {served.meta}")
        forward = PATHS["flagship"]["forward"]
        worst, texts_equal = 0.0, 0
        for i, x in enumerate(requests):
            got, _ = counted(lambda: served(x, decode_text=False), forward,
                             f"artifact request {i}")
            worst = max(worst, _held(got, loaded(x, training=True),
                                     f"artifact request {i}"))
            cats, atts, boxes, extras = served(x)
            want = loaded(x)
            if extras or not (np.array_equal(cats, want[0])
                              and np.array_equal(atts, want[1])):
                raise AssertionError(f"request {i}: decoded text differs")
            texts_equal += len(cats)
        row["artifact_max_abs_diff"] = worst
        row["artifact_request_ms"] = _host_ms(lambda: served(requests[0]))
        row["live_request_ms"] = _host_ms(lambda: loaded(requests[0]))
        _say(f"  {REQUESTS} artifact requests of {BATCH}: K1-fwd once "
             f"each; raw outputs against the live model's: largest "
             f"difference {worst:.3e} (held to 5e-2); decoded text equal on "
             f"{texts_equal} images; request {row['artifact_request_ms']:.3f}"
             f" ms, live predict {row['live_request_ms']:.3f} ms (host "
             "clock, medians of 5)")
        del served, loaded
        torch.cuda.empty_cache()

        # 4. the boosted ensemble: early-exit artifacts, then EMA
        n_blocks = 4
        x = requests[0]
        for criterion in ("confidence", "stability"):
            boosted = api.BoostedDETR(
                vocab_dict=vocab, **dict(_api_kw("boosted", codec),
                                         early_exit_criterion=criterion))
            # Adam at a constant rate, so that one step moves the weights
            # and the EMA shadow (decay 0.5) lies half way back
            trainer = boosted.compile(train_config=bt.TrainConfig(
                batch_size=BATCH, ema_decay=0.5, optimizer="adamw",
                lr_schedule="constant", clipnorm=0.0))
            _randomize_running_stats(boosted.module, seed=1)
            served = export(trainer, os.path.join(tmp, criterion),
                            f"boosted early exit ({criterion})",
                            early_exit=True, exit_criterion=criterion)
            full, _ = counted(lambda: served(x, decode_text=False),
                              forward, f"early exit {criterion}, full depth")
            if not (full["exit_block"] == n_blocks - 1).all():
                raise AssertionError(f"{criterion}: full-depth threshold "
                                     f"exits at {full['exit_block']}")
            live = boosted(x, training=True)
            cat = live["category"].astype(np.float64)
            live["category"] = cat / np.maximum(cat.sum(-1, keepdims=True),
                                                1e-9)
            worst = _held({k: full[k] for k in live}, live,
                          f"early exit {criterion} at full depth")
            blocks = make_predict_step(boosted.module,
                                       return_intermediate=True)(
                torch.from_numpy(x).cuda())
            values = (early_exit.block_confidence(blocks[0]) if criterion
                      == "confidence" else early_exit.prediction_delta(
                          blocks[0], blocks[1]))
            tau = _middle(values.cpu().numpy())
            got, _ = counted(lambda: served(x, decode_text=False,
                                            threshold=tau), forward,
                             f"early exit {criterion} at {tau}")
            want = boosted(x, training=True, early_exit_threshold=tau)
            if not np.array_equal(got["exit_block"], want["exit_block"]):
                raise AssertionError(f"{criterion} at {tau}: exit blocks "
                                     f"{got['exit_block']} against predict's "
                                     f"{want['exit_block']}")
            worst = max(worst, _held(got, {k: want[k] for k in (
                "category", "attribute", "boxes")},
                f"early exit {criterion} at {tau}"))
            row[f"early_exit_{criterion}"] = {
                "threshold": tau, "exit_block": got["exit_block"].tolist(),
                "max_abs_diff": worst}
            _say(f"  early exit ({criterion}): full depth exits at block "
                 f"{n_blocks - 1} everywhere; at {tau:.6f} exit blocks "
                 f"{got['exit_block'].tolist()}, predict's the same; largest "
                 f"difference {worst:.3e}")
            if criterion == "stability":
                # one step, so that the EMA shadow leaves the live weights
                counted(lambda: boosted.fit(batches[:1]),
                        PATHS["boosted"]["step"], "api.BoostedDETR.fit")
                served = export(trainer, os.path.join(tmp, "ema"),
                                "boosted EMA", use_ema=True)
                got, _ = counted(lambda: served(x, decode_text=False),
                                 forward, "EMA artifact")
                ema = trainer.predict(x, decode_text=False, use_ema=True)
                live = trainer.predict(x, decode_text=False)
                worst = _held(got, ema, "EMA artifact")
                moved = float(np.abs(ema["boxes"] - live["boxes"]).max())
                if not served.meta["ema_weights"] or not worst < moved:
                    raise AssertionError(f"EMA artifact: the EMA weights "
                                         f"moved the boxes by {moved}")
                row["ema_max_abs_diff"] = worst
                _say(f"  EMA artifact: the EMA predict's outputs, largest "
                     f"difference {worst:.3e}; the live weights' boxes "
                     f"{moved:.3e} away")
            del served, boosted, trainer
            torch.cuda.empty_cache()

        # 5. ViT-p16 with K3: 19 launches a request, as the live forward
        vit = api.DETR(vocab_dict=vocab, **_api_kw("vit_p16", codec))
        vit.compile()
        _randomize_running_stats(vit.module, seed=1)
        served = export(vit.trainer, os.path.join(tmp, "vit"), "vit_p16")
        vit_forward = PATHS["vit_p16"]["forward"]
        worst = 0.0
        for i, x in enumerate(requests):
            got, _ = counted(lambda: served(x, decode_text=False),
                             vit_forward, f"ViT artifact request {i}")
            worst = max(worst, _held(got, vit(x, training=True),
                                     f"ViT artifact request {i}"))
        row["vit_artifact_max_abs_diff"] = worst
        row["vit_artifact_request_ms"] = _host_ms(lambda: served(x))
        row["vit_live_request_ms"] = _host_ms(lambda: vit(x))
        _say(f"  ViT-p16 artifact: {REQUESTS} requests, K1-fwd 1 and K3-fwd "
             f"{vit_forward['attention_fwd']} each; largest difference "
             f"{worst:.3e}; request {row['vit_artifact_request_ms']:.3f} ms,"
             f" live {row['vit_live_request_ms']:.3f} ms")
        del served, vit
        torch.cuda.empty_cache()

        # 6. the CLI in this process
        cli_dir = os.path.join(tmp, "cli")
        args = ["--synthetic", "--synthetic-images", str(CLI_IMAGES)]
        steps = CLI_IMAGES // 8
        rc, _ = counted(lambda: cli.main(
            ["train", *args, "--set", "model.matcher='pallas'",
             "--log-csv", os.path.join(cli_dir, "log.csv"),
             "--save", os.path.join(cli_dir, "model")]),
            _expect(lap=steps), "cli train")
        rc2, _ = counted(lambda: cli.main(
            ["evaluate", *args, "--load", os.path.join(cli_dir, "model")]),
            _expect(), "cli evaluate")
        rc3 = cli.main(["export", "--load", os.path.join(cli_dir, "model"),
                        "--out", os.path.join(cli_dir, "artifact")])
        if (rc, rc2, rc3) != (0, 0, 0):
            raise AssertionError(f"cli exit codes {rc}, {rc2}, {rc3}")
        served = serving.load_serving(os.path.join(cli_dir, "artifact"))
        cats, _, boxes, _ = served(np.random.default_rng(0).uniform(
            0.0, 1.0, (1, 64, 64, 3)).astype(np.float32))
        if served.meta["platforms"] != ["cuda"] or not np.isfinite(
                boxes).all() or cats.shape[0] != 1:
            raise AssertionError("the CLI's artifact")
        _say(f"  cli: train ({steps} steps, K2 {steps} launches), evaluate "
             "and export on the card, exit codes 0; the artifact serves "
             f"{cats.shape[1]} slots an image")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    row["launches"] = launches
    _say(f"  api_serving phase launches: {launches}")
    return row


# The parallel phase: training across processes (parallel/). Two ranks
# share the one card over gloo with CUDA tensors (NCCL refuses two ranks on
# one device), each a process of this script (``parallel-rank``); the
# references run here, in one process, before the ranks start.
PARALLEL_RANKS = 2
# context parallelism at the 1280 encoder's shape: [BH, T, D] bf16 q, k, v,
# the keys split into two shards of 800
CP_BH, CP_T, CP_D = 64, 1600, 32
CP_SEED = 60
TP_MESH = {"data": 1, "model": 2}
CP_LAUNCHES = _expect(attention_fwd=1, attention_dq=1, attention_dkdv=1)
# the small float32 model of the data-parallel gate: the dry run's tiny
# DETR with dropout 0.1 (drawn for the global batch) and live BatchNorm
DP_SMALL = dict(num_object_preds=16, image_size=(64, 64),
                num_encoder_blocks=2, num_encoder_heads=2, encoder_dim=32,
                num_decoder_blocks=2, num_decoder_heads=2, decoder_dim=32,
                num_categories=12, num_attributes=8, backbone="tiny",
                backbone_width=0.25, compute_dtype="float32", max_objects=4,
                dropout_rate=0.1, matcher="pallas")


def _flat(tensors):
    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _calibrate(model, image):
    """Running statistics that normalise ``image`` (the global batch, in
    this process alone): its batch means and its batch variances plus 1,
    from one train-mode forward at momentum 0, as the CPU tests calibrate
    theirs (tests/test_torch_train.py::_calibrated)."""
    from boosted_detr_torch.models.backbone import BatchNorm

    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(image, generator=torch.Generator(image.device).manual_seed(0))
        for m in norms:
            del m.momentum  # the class's 0.99 again
            m.running_var.add_(1.0)


def _dp_flagship(mesh=None):
    """The 640 flagship's train step (bench.py) from its seeded state on
    the batch bench.py builds, this rank's rows of it under ``mesh`` (one
    process, all 8 rows, without): the kernel step's loss, launches, K2
    problems and new parameters; the gradients of one step from calibrated
    statistics held (``freeze_bn_stats``) with the plain forward and the
    backward kernels; then live steps timed with CUDA events, and the
    gradients' all-reduce timed alone.

    Why frozen statistics for the gradients: two ranks' bf16 forward cannot
    equal one process's bit for bit (each rank's convolutions and products
    run at its own batch size and round differently), and with live
    BatchNorm one bf16 rounding moves this step's gradients by tens of
    percent (the training phase's note on K3-fwd), so a gradient gate holds
    only where the batch statistics do not amplify rounding."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.parallel import mesh as mesh_lib

    path = PATHS["flagship"]
    cfg = _path_config("flagship", _codec())
    tcfg = bt.TrainConfig(batch_size=BATCH)
    model = _build(path, cfg, seed=0)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
    step = bt.make_train_step(model, cfg, tcfg)
    whole = _flagship_batch(cfg, BATCH, model.device)
    batch = whole if mesh is None else mesh_lib.shard_batch(whole, mesh)
    params = dict(model.named_parameters())
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    _reset_launches()
    with _lap_shapes() as shapes:
        state, aux = step(state, batch)
    torch.cuda.synchronize()
    out = {"loss": aux["loss"].item(), "launches": _launches(),
           "lap_shapes": shapes, "params": _flat(params.values())}
    model.load_state_dict(snapshot)
    _calibrate(model, whole["image"])
    calibrated = {k: v.clone() for k, v in model.state_dict().items()}
    frozen_cfg = tcfg.replace(freeze_bn_stats=True)
    plain_forward = tuple(k for k in KERNELS if k not in _BACKWARD)
    state.step = 0
    with _plain_versions(plain_forward), _lap_masks() as masks, \
            _gradients(state, params) as grads:
        state, _ = bt.make_train_step(model, cfg, frozen_cfg)(state, batch)
    out["grads"] = {k: g.float().cpu() for k, g in grads.items()}
    out["masks"] = masks
    if mesh is None:
        out["grads_rows"] = _rows_witness(model, cfg, frozen_cfg, state,
                                          params, whole, calibrated,
                                          plain_forward)
    # the same weights and calibrated statistics in float32
    cfg32 = cfg.replace(compute_dtype="float32")
    model32 = _build(path, cfg32, seed=0)
    model32.load_state_dict(calibrated)
    params32 = dict(model32.named_parameters())
    state32 = bt.TrainState.create(model32, bt.make_optimizer(
        tcfg, model32.named_parameters(), d_model=cfg.decoder_dim))
    with _plain_versions(plain_forward), _lap_masks() as masks32, \
            _gradients(state32, params32) as grads32:
        bt.make_train_step(model32, cfg32, frozen_cfg)(state32, batch)
    out["grads32"] = {k: g.float().cpu() for k, g in grads32.items()}
    out["masks32"] = masks32
    del model32, state32, params32
    step_ms = []
    for i in range(1 + 3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, batch)
        end.record()
        end.synchronize()
        if i:
            step_ms.append(start.elapsed_time(end))
    out["step_ms"] = step_ms
    if mesh is not None:
        group = mesh.groups["data"]
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out["all_reduce_bytes"] = mesh_lib.all_reduce_gradients(
                state.optimizer.params, group)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["all_reduce_ms"] = times
    return out


def _rows_witness(model, cfg, frozen_cfg, state, params, whole, calibrated,
                  plain_forward):
    """The witness that tells the ranks' rounding from their collectives:
    each rank's rows of ``whole`` stepped in this process alone, at the
    calibrated statistics with the global batch's ``1 + sum(num_objects)``
    (the only batch reduction of the frozen step's loss), and the raw
    gradients summed in float32, as the all-reduce sums them, with no
    process group."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.parallel import mesh as mesh_lib

    total = whole["num_objects"].float().sum()
    data_sum = mesh_lib.data_sum
    mesh_lib.data_sum = lambda x: total
    per = BATCH // PARALLEL_RANKS
    summed = {}
    try:
        for r in range(PARALLEL_RANKS):
            rows = {k: v[r * per:(r + 1) * per] for k, v in whole.items()}
            model.load_state_dict(calibrated)
            state.step = 0
            with _plain_versions(plain_forward), \
                    _gradients(state, params) as grads:
                bt.make_train_step(model, cfg, frozen_cfg)(state, rows)
            for k, g in grads.items():
                summed[k] = summed[k] + g.float() if k in summed \
                    else g.float()
    finally:
        mesh_lib.data_sum = data_sum
    return {k: g.cpu() for k, g in summed.items()}


def _dp_small(mesh=None):
    """One train step of the small float32 model (``DP_SMALL``) from a
    seeded state on a batch of 8 (this rank's rows under ``mesh``): its
    metrics and state."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.parallel import mesh as mesh_lib

    cfg = bt.ModelConfig(**DP_SMALL)
    model = bt.DETR(cfg, seed=3)
    tcfg = bt.TrainConfig(batch_size=8)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.parameters(), d_model=cfg.decoder_dim))
    rng = np.random.default_rng(1)
    batch = {"image": rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32),
             "category_ids": rng.integers(2, 12, (8, 4)).astype(np.int32),
             "attribute_ids": rng.integers(0, 8, (8, 4, 2)).astype(np.int32),
             "bbox": rng.uniform(0.1, 0.4, (8, 4, 4)).astype(np.float32),
             "num_objects": rng.integers(0, 5, (8,)).astype(np.int32)}
    batch = (mesh_lib.shard_batch(batch, mesh) if mesh is not None else
             {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    state, aux = bt.make_train_step(model, cfg, tcfg)(state, batch)
    return ({k: v.item() for k, v in aux.items()},
            {k: v.cpu() for k, v in model.state_dict().items()})


def _cp_inputs():
    gen = torch.Generator().manual_seed(CP_SEED)
    q, k, v, g = (torch.randn(CP_BH, CP_T, CP_D, generator=gen).to(
        "cuda", torch.bfloat16) for _ in range(4))
    return q, k, v, g


def _cp_grads(fn, q, k, v, g):
    """fn(q, k, v) and the gradients of <fn, g> for q, k and v."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    out.backward(g)
    return [out.detach().float().cpu()] + [t.grad.float().cpu()
                                           for t in leaves]


def _host_ms_sync(fn, repeats=5):
    """Median host-clock ms of ``fn`` to the card's end, after a warm-up."""
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _context_parallel(mesh):
    """This rank's shard of the context-parallel attention at the 1280
    encoder's shape through K3 (``impl="pallas"``): the merged output and
    the gradients, the launches of one forward and backward, and the
    forward's time beside K3's on the shard alone."""
    from boosted_detr_torch.ops import attention as A
    from boosted_detr_torch.parallel.context_parallel import \
        context_parallel_attention

    q, k, v, g = _cp_inputs()
    index, n = mesh.coords["model"], mesh.shape["model"]
    per = CP_T // n
    k, v = (t[:, index * per:(index + 1) * per].contiguous() for t in (k, v))

    def cp(q, k, v):
        return context_parallel_attention(q, k, v, mesh, axis="model",
                                          impl="pallas")

    _reset_launches()
    out, dq, dk, dv = _cp_grads(cp, q, k, v, g)
    launches = _launches()
    with torch.no_grad():
        cp_ms = _host_ms_sync(lambda: cp(q, k, v))
        shard_ms = _host_ms_sync(lambda: A.fused_attention_with_lse(q, k, v))
    return {"out": out, "dq": dq, "dk": dk, "dv": dv, "launches": launches,
            "cp_ms": cp_ms, "shard_ms": shard_ms,
            "merge_ms": cp_ms - shard_ms}


def _tp_model(mesh=None):
    """The 1280 flagship with K3 (bench.py's BENCH_RES=1280 BENCH_PATTN=1)
    from its seeded weights and random running statistics, split over
    ``mesh``'s 'model' axis when given."""
    from boosted_detr_torch.parallel import sharding

    path = PATHS["flagship_1280"]
    cfg = _path_config("flagship_1280", _codec())
    model = _build(path, cfg, seed=0)
    _randomize_running_stats(model, seed=1)
    if mesh is not None:
        sharding.shard_module(model, mesh)
    return cfg, model


def _tp_forward(model):
    """The raw outputs of one served request of 8 seeded 1280px images."""
    import boosted_detr_torch as bt

    images = np.random.default_rng(2).uniform(
        0.0, 1.0, (BATCH, HR_RES, HR_RES, 3)).astype(np.float32)
    return bt.predict(model, images, decode_text=False)


def _tensor_parallel(mesh):
    """The 1280 flagship split over 'model': one served forward (raw
    outputs, K3's launches and the heads each of its attentions runs), then
    one train step on 4 rows."""
    import boosted_detr_torch as bt
    from boosted_detr_torch.models.layers import MultiheadAttention

    cfg, model = _tp_model(mesh)
    heads = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: heads.append(m.num_heads))
        for m in model.modules() if isinstance(m, MultiheadAttention)]
    _reset_launches()
    raw = _tp_forward(model)
    forward_launches = _launches()
    for h in hooks:
        h.remove()
    tcfg = bt.TrainConfig(batch_size=4, mesh_shape=TP_MESH)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.named_parameters(), d_model=cfg.decoder_dim))
    batch = _flagship_batch(cfg, 4, model.device)
    _reset_launches()
    state, aux = bt.make_train_step(model, cfg, tcfg)(state, batch)
    loss = aux["loss"].item()
    return {"raw": raw, "heads": heads, "forward_launches": forward_launches,
            "step_launches": _launches(), "loss": loss}


def _add(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in KERNELS}


def parallel_rank(rank: int, init: str, out_dir: str) -> int:
    """``chip_smoke.py parallel-rank RANK INIT OUT``: one of the phase's two
    ranks, on the card over gloo. Saves its results to OUT; raises (exit
    non-zero) on a gate of its own: the DP and TP launches, the K2
    problem, the parameters of both ranks bit for bit after the DP step."""
    import torch.distributed as dist

    from boosted_detr_torch.parallel import mesh as mesh_lib
    from boosted_detr_torch.parallel import multiprocess

    multiprocess.initialize(init, PARALLEL_RANKS, rank, backend="gloo")
    dp_mesh = mesh_lib.make_mesh()
    result = {"dp": _dp_flagship(dp_mesh)}
    dp = result["dp"]
    want = PATHS["flagship"]["step"]
    per_rank = (BATCH // PARALLEL_RANKS, 32, 96)
    if dp["launches"] != want or dp["lap_shapes"] != [per_rank]:
        raise AssertionError(f"rank {rank}: DP step launches "
                             f"{dp['launches']}, K2 {dp['lap_shapes']}; "
                             f"expected {want}, K2 at {per_rank}")
    mine = dp.pop("params")
    theirs = mine.clone()
    dist.broadcast(theirs, src=0)
    if not torch.equal(mine, theirs):
        raise AssertionError(f"rank {rank}: parameters after the DP step "
                             "differ from rank 0's")
    _say(f"rank {rank}: DP step launches {dp['launches']}, K2 "
         f"{dp['lap_shapes']}, {mine.numel()} parameters equal rank 0's bit "
         "for bit")
    result["dp_small"] = _dp_small(dp_mesh)
    tp_mesh = mesh_lib.make_mesh(TP_MESH)
    result["cp"] = _context_parallel(tp_mesh)
    if result["cp"]["launches"] != CP_LAUNCHES:
        raise AssertionError(f"rank {rank}: context-parallel launches "
                             f"{result['cp']['launches']}")
    result["tp"] = tp = _tensor_parallel(tp_mesh)
    local_heads = _path_config("flagship_1280", _codec()
                               ).num_encoder_heads // TP_MESH["model"]
    if set(tp["heads"]) != {local_heads}:
        raise AssertionError(f"rank {rank}: TP attentions ran "
                             f"{sorted(set(tp['heads']))} heads")
    if (tp["forward_launches"] != PATHS["flagship_1280"]["forward"]
            or tp["step_launches"] != PATHS["flagship_1280"]["step"]
            or not np.isfinite(tp["loss"])):
        raise AssertionError(f"rank {rank}: TP forward launches "
                             f"{tp['forward_launches']}, step "
                             f"{tp['step_launches']}, loss {tp['loss']}")
    result["launches"] = _add(_add(_add(dp["launches"],
                                        result["cp"]["launches"]),
                                   tp["forward_launches"]),
                              tp["step_launches"])
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()
    return 0


def parallel_nccl(init: str, out_dir: str) -> int:
    """``chip_smoke.py parallel-nccl INIT OUT``: the flagship's DP step in
    this process without a process group, then again as the one rank of
    an NCCL group; raises unless the two are equal bit for bit."""
    import torch.distributed as dist

    from boosted_detr_torch.parallel import mesh as mesh_lib
    from boosted_detr_torch.parallel import multiprocess

    alone = _dp_flagship()
    multiprocess.initialize(init, 1, 0)
    backend = dist.get_backend()
    probe = torch.arange(8.0, device="cuda")
    dist.all_reduce(probe)
    ranked = _dp_flagship(mesh_lib.make_mesh())
    same = (alone["loss"] == ranked["loss"]
            and torch.equal(alone["params"], ranked["params"])
            and all(torch.equal(alone["grads"][k], ranked["grads"][k])
                    for k in alone["grads"]))
    _say(f"nccl: backend {backend}, world {dist.get_world_size()}; the DP "
         f"step equals the step without a process group bit for bit: {same}")
    if backend != "nccl" or not same or not torch.equal(
            probe, torch.arange(8.0, device="cuda")):
        raise AssertionError("the NCCL world-1 step differs")
    torch.save({"loss": ranked["loss"], "step_ms": ranked["step_ms"]},
               os.path.join(out_dir, "nccl.pt"))
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_parallel(rows):
    """Training across processes on the card (see the constants above):
    data parallelism on the 640 flagship and on a small float32 model,
    context parallelism at the 1280 encoder's shape, tensor parallelism on
    the 1280 flagship with K3, the CLI's multi-process launch, and one rank
    under NCCL. Adds K3's per-shard row to ``rows``."""
    import shutil
    import tempfile

    from boosted_detr_torch.ops import attention as A
    from boosted_detr_torch.parallel.dryrun import spawn

    t_phase = time.perf_counter()
    _say(f"[parallel] {PARALLEL_RANKS} ranks sharing the card over gloo "
         "(CUDA tensors); the one-process references first")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    shard = _attention_case("context-parallel shard (1280 encoder, 2 ranks)",
                            CP_BH, CP_T, CP_T // PARALLEL_RANKS, CP_D,
                            torch.bfloat16, CP_SEED + 1, flush)
    for name in ("fwd", "dq", "dkdv"):
        rows[f"attention_{name}"].append(shard[name])
    del flush
    one = _dp_flagship()
    one.pop("params")
    small_one = _dp_small()
    q, k, v, g = _cp_inputs()
    cp_kernel = _cp_grads(A.fused_attention, q, k, v, g)
    cp_plain = _cp_grads(lambda *t: A.attention_fwd_reference(*t)[0],
                         q, k, v, g)
    with torch.no_grad():
        parts = [A.attention_fwd(q, k[:, s * CP_T // 2:(s + 1) * CP_T // 2]
                                 .contiguous(),
                                 v[:, s * CP_T // 2:(s + 1) * CP_T // 2]
                                 .contiguous()) for s in range(2)]
        w = torch.softmax(torch.stack([p[1] for p in parts]), 0)[..., None]
        magnitude = sum(w[s] * parts[s][0].float().abs()
                        for s in range(2)).cpu()
    del parts, w
    tp_ref = _tp_forward(_tp_model()[1])
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="parallel_")
    try:
        init = f"file://{os.path.join(tmp, 'store')}"
        me = os.path.abspath(__file__)
        t0 = time.perf_counter()
        outs = spawn([[me, "parallel-rank", str(r), init, tmp]
                      for r in range(PARALLEL_RANKS)], timeout=600)
        ranks_s = time.perf_counter() - t0
        for r, out in enumerate(outs):
            for line in out.strip().splitlines():
                _say(f"  [rank {r}] {line}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False)
                 for r in range(PARALLEL_RANKS)]
        port = _free_port()
        cli = ["-m", "boosted_detr_torch.cli", "train", "--synthetic",
               "--synthetic-images", "8", "--model", "synthetic-tiny",
               "--epochs", "2", "--set", "train.batch_size=2", "--backend",
               "gloo", "--coordinator", f"localhost:{port}",
               "--num-processes", str(PARALLEL_RANKS), "--process-id"]
        t0 = time.perf_counter()
        cli_outs = spawn([cli + [str(r)] for r in range(PARALLEL_RANKS)],
                         timeout=300)
        cli_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl_out = spawn([[me, "parallel-nccl",
                           f"file://{os.path.join(tmp, 'nccl_store')}",
                           tmp]], timeout=300)[0]
        nccl_s = time.perf_counter() - t0
        for line in nccl_out.strip().splitlines():
            _say(f"  [nccl] {line}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    failed = []
    # data parallelism, 640 flagship: the live kernel step's loss at the
    # 1e-3 noise gate; the reduced gradients of one step at calibrated,
    # frozen statistics with the plain forward and the backward kernels,
    # all leaves and the stem's each held to 5e-2 of their norm: in bf16
    # against the witness (each rank's 4 rows stepped in one process and
    # summed, so that only the collectives differ), with all leaves also
    # against the 8-row step and the stem's shown (4-row products and
    # convolutions round otherwise than 8-row ones in bf16, and a rounding
    # early in the forward moves the stem's gradient most: the witness's
    # own stem against the 8-row step reads that alone); in float32
    # against the 8-row step
    dp = ranks[0]["dp"]
    if any(r["dp"]["loss"] != dp["loss"] for r in ranks):
        failed.append("the ranks' global losses differ")
    rel = abs(dp["loss"] - one["loss"]) / abs(one["loss"])
    stem = [k for k in one["grads"] if k.startswith("backbone")
            and "stem" in k and k.endswith("weight")]
    grad_rel = {}
    for key, got, want in (("grads", dp["grads"], one["grads"]),
                           ("grads32", dp["grads32"], one["grads32"]),
                           ("witness", dp["grads"], one["grads_rows"]),
                           ("witness_vs_one", one["grads_rows"],
                            one["grads"])):
        grad_rel[key] = (
            _norm_rel(_flat(got.values()), _flat(want.values())),
            max(_norm_rel(got[k], want[k]) for k in stem))
    moved = {}
    for key in ("masks", "masks32"):
        ours = torch.cat([r["dp"][key][0] for r in ranks])
        moved[key] = int((ours != one[key][0]).any(-1).sum())
    _say(f"  DP 640 flagship, {PARALLEL_RANKS} ranks x {BATCH // 2} rows "
         f"against one process x {BATCH}: loss {dp['loss']:.6f} against "
         f"{one['loss']:.6f} ({rel:.3e} relative, held to 1e-3); the "
         "reduced gradients at frozen statistics, bf16 "
         f"{grad_rel['grads'][0]:.3e} of their L2 norm (held to 5e-2), the "
         f"stem's {grad_rel['grads'][1]:.3e} (shown; {moved['masks']} object "
         f"rows matched otherwise); against the witness (the ranks' rows "
         f"in one process, summed) {grad_rel['witness'][0]:.3e}, the stem's "
         f"{grad_rel['witness'][1]:.3e} (each held to 5e-2); the witness "
         f"against the 8-row step {grad_rel['witness_vs_one'][0]:.3e}, the "
         f"stem's {grad_rel['witness_vs_one'][1]:.3e} (shown); float32 "
         f"{grad_rel['grads32'][0]:.3e}, the stem's "
         f"{grad_rel['grads32'][1]:.3e} (each held to 5e-2; "
         f"{moved['masks32']} rows matched otherwise)")
    if not (rel <= 1e-3 and grad_rel["grads"][0] <= 5e-2
            and max(grad_rel["witness"]) <= 5e-2
            and max(grad_rel["grads32"]) <= 5e-2):
        failed.append("the DP step is off the one-process step")
    # data parallelism, small float32 model: the small models' gates
    (want_aux, want_state) = small_one
    got_aux, got_state = ranks[0]["dp_small"]
    worst = max(abs(got_aux[k] - want_aux[k]) / max(abs(want_aux[k]), 1e-6)
                for k in want_aux)
    p_err = max((got_state[k] - v).abs().max().item()
                for k, v in want_state.items() if "running" not in k)
    s_err = max((((got_state[k] - v).abs() / v.abs().clamp_min(1e-2)).max()
                 .item() for k, v in want_state.items() if "running" in k))
    _say(f"  DP small float32 model (dropout 0.1, live BatchNorm), 2 ranks "
         f"against 1: losses within {worst:.3e} relative (held to 1e-4), "
         f"new parameters {p_err:.3e} (2e-5), running statistics "
         f"{s_err:.3e} relative (1e-4)")
    if worst > 1e-4 or p_err > 2e-5 or s_err > 1e-4:
        failed.append("the small model's DP step is off")
    # context parallelism: each output held to K3's gate of the magnitude
    # the merge summed; the gradients to 2**-7 of their norm and to 2**-6
    # of each row's norm (one token of one head, so that a fault in a few
    # rows shows: a row of dq is two bf16 partials summed and rounded
    # again, each rounding up to 2**-9 of a partial's norm, which can pass
    # the sum's). K3's elementwise gradient gate, 1e-4 + 2**-7 |ref|, is
    # shown, beside the one-process K3's own count against the plain
    # version: neither end-to-end backward holds it
    got = {"out": ranks[0]["cp"]["out"], "dq": ranks[0]["cp"]["dq"],
           "dk": torch.cat([r["cp"]["dk"] for r in ranks], 1),
           "dv": torch.cat([r["cp"]["dv"] for r in ranks], 1)}
    if not torch.equal(ranks[1]["cp"]["out"], got["out"]):
        failed.append("the ranks' merged outputs differ")
    cp_row = {}

    def _outside(got, want):
        return int(((got - want).abs() > 1e-4 + 2.0 ** -7 * want.abs()).sum())

    def _worst_row(got, want):
        return ((got.double() - want.double()).norm(dim=-1)
                / want.double().norm(dim=-1)).max().item()

    alone = {x: (_outside(cp_kernel[i + 1], cp_plain[i + 1]),
                 _worst_row(cp_kernel[i + 1], cp_plain[i + 1]))
             for i, x in enumerate(("dq", "dk", "dv"))}
    _say("  the one-process K3's gradients against the plain version: "
         "values outside 1e-4 + 2**-7 |ref| " + ", ".join(
             f"{x} {n} of {cp_plain[1].numel()}" for x, (n, _) in
             alone.items()) + "; the worst row " + ", ".join(
             f"{x} {r:.3e}" for x, (_, r) in alone.items())
         + " of its norm (shown)")
    cp_row["one-process K3 against the plain version"] = alone
    for label, ref in (("one-process K3", cp_kernel),
                       ("plain version", cp_plain)):
        err = (got["out"] - ref[0]).abs()
        bound = 1e-5 + 2.0 ** -7 * torch.maximum(magnitude, ref[0].abs())
        bad = int((err > bound).sum())
        rels, row_rels, outside = {}, {}, {}
        for i, x in enumerate(("dq", "dk", "dv")):
            want = ref[i + 1]
            rels[x] = _norm_rel(got[x], want)
            row_rels[x] = _worst_row(got[x], want)
            outside[x] = _outside(got[x], want)
        _say(f"  context parallel against the {label}: out max abs err "
             f"{err.max().item():.3e}, {bad} of {err.numel()} values "
             "outside 1e-5 + 2**-7 x the merged magnitude; gradients " +
             ", ".join(f"{x} {v:.3e}" for x, v in rels.items())
             + " of their L2 norm (held to 2**-7), the worst row " +
             ", ".join(f"{x} {v:.3e}" for x, v in row_rels.items())
             + " of its norm (held to 2**-6); values outside 1e-4 + 2**-7 "
             "|ref| " + ", ".join(f"{x} {v} of {got[x].numel()}"
                                  for x, v in outside.items())
             + " (shown)")
        if (bad or max(rels.values()) > 2.0 ** -7
                or max(row_rels.values()) > 2.0 ** -6):
            failed.append(f"context parallel off the {label}")
        cp_row[label] = dict(out_max_abs_err=err.max().item(), **rels,
                             row_norm_rel=row_rels, values_outside=outside)
    # tensor parallelism: the forward at the serving gate
    try:
        tp_err = _held(ranks[0]["tp"]["raw"], tp_ref, "TP 1280 forward (2 "
                       "ranks, 4 heads each) against the unsharded one")
    except AssertionError as exc:
        failed.append(str(exc))
        tp_err = float("nan")
    _say(f"  TP step loss {ranks[0]['tp']['loss']:.4f} (finite)")
    # the CLI's two processes
    finals = [re.search(r"final loss: ([\d.]+)", out) for out in cli_outs]
    if not all(finals) or finals[0].group(1) != finals[1].group(1):
        failed.append("the CLI ranks' final losses: "
                      + " | ".join(o[-300:] for o in cli_outs))
    _say(f"  CLI train --coordinator localhost:{port}: both ranks print "
         f"final loss: {finals[0].group(1)}")
    for r, rank in enumerate(ranks):
        d = rank["dp"]
        _say(f"  rank {r}: DP step {statistics.median(d['step_ms']):.3f} ms "
             f"(median of {len(d['step_ms'])}, CUDA events; one process "
             f"{statistics.median(one['step_ms']):.3f} ms), gradient "
             f"all-reduce {statistics.median(d['all_reduce_ms']):.3f} ms "
             f"(host clock) for {d['all_reduce_bytes']} bytes; context "
             f"parallel forward {rank['cp']['cp_ms']:.3f} ms, K3 on the "
             f"shard alone {rank['cp']['shard_ms']:.3f} ms, merge "
             f"{rank['cp']['merge_ms']:.3f} ms (host clock)")
    row = {"launches": ranks[0]["launches"],
           "rank_launches": [r["launches"] for r in ranks],
           "dp_loss_rel_diff": rel, "dp_grad_rel_diff": grad_rel,
           "dp_rows_matched_otherwise": moved,
           "dp_small_loss_rel_diff": worst,
           "dp_step_ms": [statistics.median(r["dp"]["step_ms"])
                          for r in ranks],
           "one_process_step_ms": statistics.median(one["step_ms"]),
           "all_reduce_ms": [statistics.median(r["dp"]["all_reduce_ms"])
                             for r in ranks],
           "all_reduce_bytes": dp["all_reduce_bytes"],
           "cp": cp_row, "cp_merge_ms": [r["cp"]["merge_ms"] for r in ranks],
           "tp_forward_max_abs_err": tp_err, "tp_loss": ranks[0]["tp"]["loss"],
           "ranks_s": ranks_s, "cli_s": cli_s, "nccl_s": nccl_s,
           "phase_s": time.perf_counter() - t_phase}
    _say(f"  parallel phase launches (rank 0): {row['launches']}; "
         f"{row['phase_s']:.1f} s in all (ranks {ranks_s:.1f} s, CLI "
         f"{cli_s:.1f} s, NCCL {nccl_s:.1f} s)")
    if failed:
        raise AssertionError("parallel phase: " + "; ".join(failed))
    return row


# The benchmark suite's commands, each run in a fresh process from the root
# of the checkout, with its time limit in seconds.
BENCHMARKS = {
    "cli benchmark --quick": (["-m", "boosted_detr_torch.cli", "benchmark",
                               "--quick"], 600),
    # 20 steps a chunk (100 as users run it): the same gates, ~70 s less
    "bench_torch.py": (["bench_torch.py", "--steps", "20"], 600),
    "profile_step --steps 2": (["-m", "boosted_detr_torch.benchmarks."
                                "profile_step", "--steps", "2"], 600),
}
QUICK_LINES = ("matcher_hungarian_plain", "matcher_hungarian_kernel",
               "matcher_auction", "matcher_native_cpp_host",
               "train_detr_resnet_640")


def _positive(line, keys, what):
    bad = {k: line.get(k) for k in keys
           if not (isinstance(line.get(k), (int, float))
                   and math.isfinite(line[k]) and line[k] > 0)}
    if bad:
        raise AssertionError(f"{what}: not positive and finite: {bad}")


def phase_benchmarks():
    """The benchmark suite as users run it, each command in a process of
    its own: ``cli benchmark --quick`` (the matchers and the first
    throughput configuration), ``bench_torch.py --steps 20`` (the 640
    flagship's train and inference throughput, 20 steps a chunk) and
    ``profile_step --steps 2``. Gates: each
    command exits 0; every expected line is there, names the card and its
    power limit and has positive, finite times; K2 launched on
    ``matcher_hungarian_kernel`` and not on ``matcher_hungarian_plain``;
    bench_torch.py launched K1-fwd, K1-dW and K2 and no K3; the profile
    saw K1, K2 and every component. Returns the lines and the launches
    summed over them."""
    from boosted_detr_torch.benchmarks import profile_step

    card = torch.cuda.get_device_name(0)
    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    out = {}
    for label, (args, timeout) in BENCHMARKS.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *args], cwd=root,
                              capture_output=True, text=True, check=False,
                              timeout=timeout)
        seconds = time.perf_counter() - t0
        for text in proc.stdout.strip().splitlines():
            _say(f"  [{label}] {text}")
        if proc.returncode != 0:
            raise AssertionError(f"{label} exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        _say(f"[benchmarks] {label}: {seconds:.1f} s")
        out[label] = proc.stdout
    lines = [json.loads(t) for t in out["cli benchmark --quick"].splitlines()
             if t.startswith("{")]
    by_name = {line["benchmark"]: line for line in lines}
    if list(by_name) != list(QUICK_LINES):
        raise AssertionError(f"benchmark --quick printed {list(by_name)}, "
                             f"expected {list(QUICK_LINES)}")
    bench = json.loads(out["bench_torch.py"].strip().splitlines()[-1])
    profile = json.loads(next(
        t for t in out["profile_step --steps 2"].splitlines()
        if t.startswith("PROFILE_STEP "))[len("PROFILE_STEP "):])
    for line in lines + [bench, profile]:
        what = line.get("benchmark", line.get("metric", "profile_step"))
        if line["device"] != card:
            raise AssertionError(f"{what}: device {line['device']!r}, the "
                                 f"card is {card!r}")
        _positive(line, ["power_limit_w"], what)
    for line in lines:
        key = "ms_per_solve" if "ms_per_solve" in line else "ms_per_step"
        _positive(line, [key, f"{key}_q1", f"{key}_q3"], line["benchmark"])
    _positive(by_name["train_detr_resnet_640"], ["images_per_sec"],
              "train_detr_resnet_640")
    if not math.isfinite(by_name["train_detr_resnet_640"]["loss"]):
        raise AssertionError("train_detr_resnet_640: the loss is not finite")
    k2 = {n: by_name[f"matcher_hungarian_{n}"]["kernel_launches"]["lap"]
          for n in ("kernel", "plain")}
    if not (k2["kernel"] > 0 and k2["plain"] == 0):
        raise AssertionError(f"K2's launches on the matcher lines: {k2}")
    _positive(bench, ["value", "train_step_ms", bench["metric"].replace(
        "train_", "inference_", 1)], "bench_torch.py")
    if not math.isfinite(bench["final_loss"]):
        raise AssertionError("bench_torch.py: the final loss is not finite")
    launched = bench["kernel_launches"]
    if (min(launched[k] for k in ("patchify_fwd", "patchify_dw", "lap")) == 0
            or any(launched[k] for k in _K3)):
        raise AssertionError(f"bench_torch.py launched {launched}: K1-fwd, "
                             "K1-dW and K2 expected, no K3")
    _positive(profile, ["device_ms_per_step", "busy_share"], "profile_step")
    seen = {k for k, v in profile["by_category"].items() if v > 0}
    comps = {k for k, v in profile["by_component"].items() if v > 0}
    if (not {"K1-fwd", "K1-dW", "K2"} <= seen
            or not set(profile_step.COMPONENTS) - {"other"} <= comps):
        raise AssertionError(f"profile_step saw categories {sorted(seen)}, "
                             f"components {sorted(comps)}")
    launches = {name: sum(line["kernel_launches"][name]
                          for line in lines + [bench]) for name in KERNELS}
    seconds = time.perf_counter() - t_phase
    _say(f"[benchmarks] launches over the timed chunks {launches}; "
         f"{seconds:.1f} s")
    return {"launches": launches, "seconds": seconds, "lines": lines,
            "bench_torch": bench, "profile_step": profile}


def _kernel_line(rows, paths):
    """The ``kernels`` JSON line: each kernel at its main shape (the first
    row of its list: the 640px flagship's for K1 and K2, the 1280px
    encoder's in bf16 for K3), with its launches summed over the main
    paths; K3's entries also list, under ``routes``, the bf16 kernels up
    to D = 128 by name at their shapes, and K2's its slots and columns
    kernels at each of its shapes."""
    out = []
    for name, (*_, source, replaces) in KERNELS.items():
        main_row = rows[name][0]
        # the share of the bound and the time with the launch enqueued
        # ahead of the card; K1's whole library calls; K2's longest chain
        # of Dijkstra steps and its serial-chain yardstick
        extra = {k: main_row[k]
                 for k in ("bound_share", "device_ms", "library_full_ms",
                           "longest_steps", "chain_ms", "chain_share")
                 if k in main_row}
        routes = [{k: r[k] for k in ("kernel", "shape", "ms", "device_ms",
                                     "bound_ms", "bound_cuda_core_ms",
                                     "bound_share", "library_ms",
                                     "library_device_ms", "registers",
                                     "spill_bytes")
                   if k in r} for r in rows[name] if "kernel" in r]
        if routes:
            extra["routes"] = routes
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(p["launches"][name] for p in paths),
            "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"], **extra})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["kernel-names"]:
        return kernel_names()
    if sys.argv[1:2] == ["parallel-rank"]:
        return parallel_rank(int(sys.argv[2]), *sys.argv[3:5])
    if sys.argv[1:2] == ["parallel-nccl"]:
        return parallel_nccl(*sys.argv[2:4])
    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")

    t_start = time.perf_counter()
    seconds = {}  # of each phase, to see what a longer run spends

    def lap(phase):
        seconds[phase] = round(time.perf_counter() - t_start
                               - sum(seconds.values()), 1)

    ptxas = phase_build()
    lap("build")
    rows = phase_kernels(ptxas)
    lap("kernels")
    matchers = phase_matchers()
    lap("matchers")
    report = {}
    for name in PATHS:
        if "train_only" in PATHS[name]:
            report[name] = {"training": phase_training(
                name, *PATHS[name]["train_only"])}
            torch.cuda.empty_cache()
            lap(name)
            continue
        serving = phase_serving(name)
        if name == "boosted":
            extra = phase_early_exit(name, serving["model"],
                                     serving["images"])
            serving.update(extra)
            serving["launches"] = {
                k: v + extra["early_exit_launches"][k]
                + extra["incremental_launches"][k]
                + sum(m["launches"][k] for m in extra["modes"].values())
                for k, v in serving["launches"].items()}
        serving.update(phase_breakdown(
            name, serving.pop("model"), serving.pop("codec"),
            serving.pop("images")))
        torch.cuda.empty_cache()
        warmup, steps = ((TRAIN_WARMUP, TRAIN_STEPS) if name == "flagship"
                         else (HR_TRAIN_WARMUP, HR_TRAIN_STEPS))
        report[name] = {"serving": serving,
                        "training": phase_training(name, warmup, steps)}
        torch.cuda.empty_cache()
        lap(name)
    report["trainer"] = {"training": phase_trainer()}
    torch.cuda.empty_cache()
    lap("trainer")
    report["api_serving"] = {"serving": phase_api_serving()}
    torch.cuda.empty_cache()
    lap("api_serving")
    report["parallel"] = {"training": phase_parallel(rows)}
    torch.cuda.empty_cache()
    lap("parallel")
    report["benchmarks"] = {"benchmarks": phase_benchmarks()}
    lap("benchmarks")
    for label, (path, cfg, train_kw) in _small_configs().items():
        phase_small_reference(label, path, cfg, train_kw)
    lap("small_reference")
    phase_kernel_names()
    lap("kernel_names")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _say("[report] ptxas K3: " + json.dumps(ptxas))
    _say("[report] per-shape kernel rows: " + json.dumps(rows))
    _say("[report] matchers: " + json.dumps(matchers))
    for name, parts in report.items():
        for part, row in parts.items():
            _say(f"[report] {part} {name}: " + json.dumps(row))
    _say("[report] seconds by phase: " + json.dumps(seconds))
    _say(f"[report] {time.perf_counter() - t_start:.1f} s in all")
    _say(card)
    paths = [row for parts in report.values() for row in parts.values()]
    print(json.dumps(_kernel_line(rows, paths)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
