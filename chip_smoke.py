"""Chip smoke test of the PyTorch port on one CUDA card (an H100).

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. build: compiles every hand-written kernel under boosted_detr_torch/csrc/
   with nvcc for sm_90a, one process per source, all at once;
2. kernels: calls each kernel's wrapper on the card at the shapes the
   serving path gives it (and the port's other patchify shapes), holds the
   result against the plain PyTorch version on the same inputs, and times
   kernel, plain version and one PyTorch library call with CUDA events;
3. serving: builds the flagship DETR (640x640, batch 8, bf16, ResNet
   patchify8 stem through the kernel) from seeded random weights and
   running statistics, serves a few requests through ``predict``, checks
   the outputs, and compares the same model with its stem switched to the
   plain version; then holds a small float32 DETR on the card against the
   same weights on the CPU, the path the CPU tests hold against JAX;
4. report: the card's name and power limit, a ``kernels`` JSON line, and
   the last line ``{"ok": true, "device": {...}}``.

The launch counters are set to 0 just before the requests and read just
after, so ``launches`` counts what the serving path ran. TF32 is off for
matmuls and convolutions, so that every float32 comparison is float32.
Without a CUDA card it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
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
WARMUP, REPEATS = 3, 25
REQUESTS, BATCH, RES = 3, 8, 640


def _say(*parts):
    print(*parts, flush=True)


def _close(out, ref, atol, rtol, what):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-6)).max().item()
    bad = (err > atol + rtol * ref.abs()).sum().item()
    _say(f"  {what}: max abs err {max_abs:.3e}, max rel err {max_rel:.3e} "
         f"(atol {atol:g}, rtol {rtol:g}); {bad} values outside")
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f"{what}: {bad} values outside the tolerance")
    return max_abs


def _time_ms(fn, flush):
    """Median of REPEATS launches timed one by one with CUDA events, each
    after a write of a buffer larger than the 50 MB L2, so that every launch
    finds its inputs in device memory as a fresh request would."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPEATS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_build():
    from boosted_detr_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_all()
    _say(f"[build] {len(libs)} kernel source(s) in "
         f"{time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text()
        for line in log.splitlines():
            if "registers" in line or "Compiling entry" in line:
                _say(f"  {name}: {line.strip()}")


def _patchify_case(patch, c_out, dtype, seed, flush):
    from boosted_detr_torch.ops import patchify as P

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((BATCH, RES, RES, 3), generator=gen, device="cuda")
    x = x * 1.2 - 0.1  # a little outside [0, 1], so that the clip works
    k = patch * patch * 3
    w = (torch.randn((patch, patch, 3, c_out), generator=gen, device="cuda")
         * (2.0 / k ** 0.5)).to(dtype)
    out = P.patchify_conv(x, w, clip01=True)
    ref = P.patchify_conv_reference(x, w, clip01=True)
    torch.cuda.synchronize()
    what = f"P={patch} -> {c_out} {str(dtype)[6:]}"
    # float32: only the order of the float32 sums differs. bfloat16: both
    # round identical inputs and sum in float32, so the outputs differ by
    # at most one rounding of the bf16 result, 2**-7 relative.
    tol = (dict(atol=1e-4, rtol=1e-5) if dtype == torch.float32
           else dict(atol=1e-5, rtol=2.0 ** -7))
    max_abs = _close(out, ref, what=what, **tol)
    row = {"shape": what, "max_abs_err": max_abs}
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
    xc = x.clamp(0.0, 1.0).to(dtype).permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    lib = torch.nn.functional.conv2d(xc, wc, stride=patch)
    lib_err = (lib.permute(0, 2, 3, 1).float() - ref.float()).abs().max()
    _say(f"  {what} cuDNN yardstick: max abs err {lib_err.item():.3e}")
    row.update(
        ms=_time_ms(lambda: P.patchify_conv(x, w, clip01=True), flush),
        plain_ms=_time_ms(
            lambda: P.patchify_conv_reference(x, w, clip01=True), flush),
        library_ms=_time_ms(
            lambda: torch.nn.functional.conv2d(xc, wc, stride=patch), flush))
    _say(f"  {what}: kernel {row['ms']:.4f} ms, plain "
         f"{row['plain_ms']:.4f} ms, cuDNN {row['library_ms']:.4f} ms, "
         f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_kernels():
    _say("[kernels] patchify_conv against patchify_conv_reference on the "
         f"card, x f32 [{BATCH}, {RES}, {RES}, 3]")
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    return [_patchify_case(8, 128, torch.bfloat16, 0, flush),
            _patchify_case(8, 128, torch.float32, 1, flush),
            _patchify_case(4, 64, torch.bfloat16, 2, flush),
            _patchify_case(16, 384, torch.bfloat16, 3, flush)]


def _randomize_running_stats(model, seed):
    from boosted_detr_torch.models.backbone import BatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)


def _known_attributes(text, names):
    """True when ``text`` is a ", "-joined run of names from ``names``
    (some names hold ", " themselves, e.g. "letters, numbers")."""
    part = ""
    for token in filter(None, text.split(", ")):
        part = f"{part}, {token}" if part else token
        if part in names:
            part = ""
    return part == ""


def phase_serving():
    import boosted_detr_torch as bt
    from boosted_detr_torch.data import vocabularies
    from boosted_detr_torch.data.codec import TextCodec
    from boosted_detr_torch.ops import patchify as P

    # The flagship of bench.py: COCO's 80 categories and Fashionpedia's 294
    # attributes, each with <PAD> and <OOV>.
    vocab = {"category": vocabularies.vocab_dict("COCO")["category"],
             "attribute": vocabularies.vocab_dict("Fashionpedia")[
                 "attribute"]}
    codec = TextCodec(vocab)
    cfg = bt.ModelConfig(image_size=(RES, RES), backbone="resnet",
                         stem="patchify8", use_pallas_stem=True,
                         norm="batchnorm", compute_dtype="bfloat16",
                         num_categories=len(codec.category_vocab),
                         num_attributes=len(codec.attribute_vocab))
    t0 = time.perf_counter()
    model = bt.DETR(cfg, seed=0)  # on cuda: the entry point's default
    _randomize_running_stats(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    _say(f"[serving] flagship DETR, {n_params} parameters, built in "
         f"{time.perf_counter() - t0:.1f} s on {model.device}")
    rng = np.random.default_rng(0)
    requests = [rng.uniform(0.0, 1.0, (BATCH, RES, RES, 3)).astype(np.float32)
                for _ in range(REQUESTS)]

    bt.predict(model, requests[0], codec)  # warm-up: cuDNN and cuBLAS plans
    torch.cuda.synchronize()
    P.patchify_conv.launches = 0
    results, latencies = [], []
    for images in requests:
        t0 = time.perf_counter()
        results.append(bt.predict(model, images, codec))
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = P.patchify_conv.launches
    _say(f"  patchify_conv launches over {REQUESTS} requests: {launches}")
    if launches != REQUESTS:
        raise AssertionError(f"expected {REQUESTS} stem launches, got "
                             f"{launches}")
    for i, ms in enumerate(latencies):
        _say(f"  request {i}: {BATCH} images in {ms:.2f} ms")
    total_s = sum(latencies) / 1e3
    _say(f"  {REQUESTS * BATCH / total_s:.2f} images/s over {REQUESTS} "
         f"requests (host clock, H2D copy and text decode included)")

    words = set(codec.category_vocab)
    attrs = set(codec.attribute_vocab[2:])
    for cats, atts, boxes in results:
        assert cats.shape == atts.shape == (BATCH, cfg.num_object_preds)
        assert set(cats.ravel()) <= words
        assert all(_known_attributes(a, attrs) for a in atts.ravel())
        assert boxes.shape == (BATCH, cfg.num_object_preds, 4)
        assert np.isfinite(boxes).all()
        assert ((boxes > -1.0) & (boxes < 2.0)).all()

    raw = bt.predict(model, requests[0], codec, decode_text=False)
    sums = raw["category"].sum(-1)
    if not np.allclose(sums, 1.0, atol=1e-5):
        raise AssertionError(f"softmax rows sum to {sums.min()}..{sums.max()}")
    assert ((raw["attribute"] >= 0) & (raw["attribute"] <= 1)).all()
    _say("  outputs: categories and attributes from the vocabulary, softmax "
         "rows sum to 1, boxes in (-1, 2)")

    # The same model with the stem on the plain version on the card. The
    # stems agree to one bf16 rounding; that propagates through bf16
    # compute, so probabilities and boxes are held to 5e-2.
    kernel_stem = P.patchify_conv
    P.patchify_conv = P.patchify_conv_reference
    try:
        plain = bt.predict(model, requests[0], codec, decode_text=False)
    finally:
        P.patchify_conv = kernel_stem
    for key in ("category", "attribute", "boxes"):
        _close(torch.from_numpy(raw[key]), torch.from_numpy(plain[key]),
               atol=5e-2, rtol=0.0, what=f"serving {key}, kernel vs plain stem")
    return {"images_per_s": REQUESTS * BATCH / total_s,
            "latency_ms": latencies, "launches": launches,
            "model": model, "codec": codec, "images": requests[0]}


def _host_ms(fn, repeats=5):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_breakdown(model, codec, images, stem_ms):
    """Where one flagship request's time goes: the host-to-device copy of
    the images, the forward on the card, the text decode on the host, and
    the forward's kernels by device time (torch.profiler)."""
    from boosted_detr_torch.train.steps import make_predict_step

    step = make_predict_step(model)
    x = torch.from_numpy(images).cuda()
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    raw = {k: v.cpu().numpy() for k, v in step(x).items()}
    row = {"h2d_ms": _host_ms(lambda: torch.from_numpy(images).cuda()),
           "forward_ms": _time_ms(lambda: step(x), flush),
           "decode_ms": _host_ms(lambda: codec.decode_predictions(raw))}
    _say(f"[breakdown] one request of {BATCH}: H2D copy {row['h2d_ms']:.3f} "
         f"ms (host clock), forward {row['forward_ms']:.3f} ms (CUDA events),"
         f" text decode {row['decode_ms']:.3f} ms (host clock); the stem "
         f"kernel is {100 * stem_ms / row['forward_ms']:.2f}% of the forward")
    n = 5
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        _say("  profiler: no device time recorded; kernel breakdown not "
             "measured")
        return row
    row["device_busy_share"] = busy_us / wall_us
    _say(f"  profiler, {n} forwards: device busy {busy_us / n / 1e3:.3f} ms "
         f"per forward, {100 * busy_us / wall_us:.1f}% of the wall time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        _say(f"    {e.self_device_time_total / n / 1e3:8.3f} ms "
             f"{100 * e.self_device_time_total / busy_us:5.1f}% "
             f"x{e.count // n:<4d} {e.key[:90]}")
    return row


def phase_small_reference():
    """A small float32 DETR on the card against the same weights on the CPU,
    where the port runs the plain versions that the CPU tests hold against
    the JAX package."""
    import boosted_detr_torch as bt

    cfg = bt.ModelConfig(image_size=(64, 64), backbone="resnet",
                         backbone_width=0.25, stem="patchify8",
                         use_pallas_stem=True, compute_dtype="float32",
                         num_encoder_blocks=2, num_decoder_blocks=2,
                         encoder_dim=64, decoder_dim=64, num_object_preds=16,
                         num_categories=12, num_attributes=20)
    cpu = bt.DETR(cfg, device="cpu", seed=2)
    _randomize_running_stats(cpu, seed=3)
    gpu = bt.DETR(cfg, seed=2)
    gpu.load_state_dict(cpu.state_dict())
    images = np.random.default_rng(4).uniform(
        -0.05, 1.05, (2, 64, 64, 3)).astype(np.float32)
    want = bt.predict(cpu, images, decode_text=False)
    got = bt.predict(gpu, images, decode_text=False)
    _say("[small reference] float32 DETR 64x64, card against CPU")
    # float32 throughout: the sums run in another order (cuDNN, cuBLAS and
    # the kernel against oneDNN), ~1e-6 at this size; 1e-4 leaves room.
    for key in ("category", "attribute", "boxes"):
        _close(torch.from_numpy(got[key]), torch.from_numpy(want[key]),
               atol=1e-4, rtol=1e-4, what=key)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"{torch.cuda.get_device_name(0)}")

    phase_build()
    rows = phase_kernels()
    serving = phase_serving()
    breakdown = phase_breakdown(serving.pop("model"), serving.pop("codec"),
                                serving.pop("images"), rows[0]["ms"])
    phase_small_reference()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _say("[report] per-shape patchify rows: " + json.dumps(rows))
    _say("[report] serving: " + json.dumps(dict(serving, **breakdown)))
    _say(card)
    main_row = rows[0]  # the serving path's shape: P=8 -> 128, bf16
    print(json.dumps({"kernels": [{
        "name": "patchify_fwd",
        "route": "cuda",
        "source": "boosted_detr_torch/csrc/patchify.cu",
        "replaces": "boosted_detr_tpu/ops/pallas_patchify.py:122",
        "launches": serving["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
