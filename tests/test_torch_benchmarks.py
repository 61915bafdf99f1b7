"""The port's benchmark suite (boosted_detr_torch/benchmarks/ and the root's
bench_torch.py) on the CPU, against the JAX suite (benchmarks/
run_benchmarks.py and bench.py, read and never edited):

- ``make_batch`` bit for bit against JAX's from one seed, the shared
  generator's sequence over the nine configurations and the panoptic masks
  drawn after it;
- the nine throughput configurations, the other models' configuration,
  bench.py's defaults and switches and its ``BENCH_SET`` parsing against
  the JAX files' own code, read with ``ast``;
- one run of every benchmark at tiny widths with ``device="cpu"`` (each
  line's keys and names, a finite loss), and the refusal without a card;
- ``profile_step``: the categories of kernel names read from a profile of
  the flagship on an H100, and the attribution of a tiny train step's
  operators to components, backward ones included;
- ``roofline``: its counts of a bottleneck block and an attention layer
  against sums of 2·M·N·K by hand.
No timing is measured here."""

import ast
import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmarks import run_benchmarks as jrb
from boosted_detr_tpu import config as jconfig
from boosted_detr_torch import config as tconfig
from boosted_detr_torch.benchmarks import profile_step, roofline
from boosted_detr_torch.benchmarks import run_benchmarks as rb

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench_torch  # noqa: E402  (the root script, beside bench.py)

torch.set_num_threads(2)
TINY = dict(image_size=(64, 64), backbone_width=0.01, num_encoder_blocks=1,
            encoder_dim=16, num_encoder_heads=2, num_decoder_blocks=2,
            decoder_dim=16, num_decoder_heads=2, num_object_preds=8,
            max_objects=4, compute_dtype="float32")
TINY_SET = ",".join(f"{k}={v}" for k, v in TINY.items()
                    if k != "image_size")
FAST = dict(chunks=2, warmup=1)
LINE_KEYS = {"benchmark", "chunks", "steps_per_chunk", "device",
             "power_limit_w", "kernel_launches"}


def _function(path, name):
    tree = ast.parse(path.read_text())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _call_fields(call):
    return {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}


def test_make_batch_matches_jax_over_the_configurations():
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    for _, fields, _, bs in rb.THROUGHPUT_CONFIGS:
        fields = dict(fields, image_size=(16, 24))
        ours = rb.make_batch(bs, tconfig.ModelConfig(**fields), rng_t, "cpu")
        ref = jrb.make_batch(bs, jconfig.ModelConfig(**fields), rng_j)
        assert ours.keys() == ref.keys()
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v))
            assert ours[k].numpy().dtype == np.asarray(v).dtype
    # the other models: the batch, then the masks from the same generator
    # (benchmarks/run_benchmarks.py:236-241)
    cfg = dict(rb.OTHER_MODELS_CONFIG, image_size=(16, 16))
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    batch, pbatch = rb.other_models_batch(8, tconfig.ModelConfig(**cfg),
                                          rng_t, "cpu")
    ref = jrb.make_batch(8, jconfig.ModelConfig(**cfg), rng_j)
    masks = rng_j.integers(0, 2, (8, 32, rb.MASK_SIZE, rb.MASK_SIZE))
    np.testing.assert_array_equal(pbatch["masks"].numpy(),
                                  masks.astype(np.float32))
    for k, v in ref.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v))
        assert pbatch[k] is batch[k]


def test_configurations_match_the_jax_suite():
    path = ROOT / "benchmarks" / "run_benchmarks.py"
    fn = _function(path, "bench_throughput")
    listed = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "configs")
    ref = [(e.elts[0].value, _call_fields(e.elts[1]), e.elts[2].id,
            e.elts[3].value) for e in listed.elts]
    assert len(ref) == 9
    assert [tuple(c) for c in rb.THROUGHPUT_CONFIGS] == ref
    other = _function(path, "bench_other_models")
    call = next(n.value for n in ast.walk(other) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "cfg")
    assert rb.OTHER_MODELS_CONFIG == _call_fields(call)
    # every field is one the port's ModelConfig has
    for _, fields, _, _ in rb.THROUGHPUT_CONFIGS:
        tconfig.ModelConfig(**fields)


def _bench_py_flagship(env):
    """bench.py's main up to the model choice, run with ``env`` as its
    environment: (batch size, ModelConfig, BENCH_MODEL, BENCH_FBN)."""
    fn = _function(ROOT / "bench.py", "main")
    stop = next(i for i, s in enumerate(fn.body) if isinstance(s, ast.If)
                and "bench_model" in ast.unparse(s.test))
    body = [s for s in fn.body[:stop]
            if not isinstance(s, (ast.Import, ast.ImportFrom))]
    scope = {"os": type("os", (), {"environ": env}),
             "ModelConfig": jconfig.ModelConfig}
    exec(compile(ast.Module(body, []), "bench.py", "exec"), scope)
    return (scope["batch_size"], scope["cfg"], scope["bench_model"],
            scope["fbn"])


@pytest.mark.parametrize("env", [
    {},
    {"BENCH_RES": "1280", "BENCH_PATTN": "1"},
    {"BENCH_BATCH": "4", "BENCH_BACKBONE": "vit", "BENCH_STEM": "patchify",
     "BENCH_NORM": "skipinit", "BENCH_PSTEM": "0", "BENCH_MODEL": "boosted",
     "BENCH_FBN": "1",
     "BENCH_SET": "num_encoder_blocks=8,encoder_dim=384,dropout_rate=0.0,"
                  "post_softmax_mask=False,backbone=vit_p32"},
])
def test_bench_torch_flagship_is_bench_py_s(env):
    bs, cfg, model, fbn = _bench_py_flagship(env)
    ours, tcfg, our_model, our_bs = rb.flagship_from_env(env)
    assert dataclasses.asdict(ours) == dataclasses.asdict(cfg)
    assert (our_bs, our_model, tcfg.freeze_bn_stats) == (bs, model, fbn)
    assert tcfg.batch_size == bs
    assert tcfg.use_intermediate_losses == (model == "boosted")


def test_bench_set_parsing_is_bench_py_s():
    fn = _function(ROOT / "bench.py", "main")
    parse = next(n for n in ast.walk(fn)
                 if isinstance(n, ast.FunctionDef) and n.name == "parse")
    scope = {}
    exec(compile(ast.Module([parse], []), "bench.py", "exec"), scope)
    for kv in ("a=1", "b=2.5", "c=True", "d=False", "e=vit_p32", "f=1e-3",
               "g=", "h=a=b", "i=-4", "j=true"):
        got, want = rb.parse_set(kv), scope["parse"](kv)
        assert got == want and type(got[1]) is type(want[1]), kv


def _lines(capsys):
    return [json.loads(s) for s in capsys.readouterr().out.splitlines()
            if s.startswith("{")]


def _check_line(line, want_key):
    assert LINE_KEYS | {want_key, f"{want_key}_q1",
                        f"{want_key}_q3"} <= line.keys()
    assert line[f"{want_key}_q1"] <= line[want_key] <= line[f"{want_key}_q3"]
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["kernel_launches"] == dict.fromkeys(rb.KERNEL_WRAPPERS, 0)
    assert line["chunks"] == FAST["chunks"]


def test_the_suite_runs_on_the_cpu_at_tiny_widths(capsys):
    rb.bench_matcher("cpu", solves=2, **FAST)
    rb.bench_throughput(True, "cpu", TINY, steps=1, **FAST)
    rb.bench_other_models("cpu", TINY, steps=1, **FAST)
    lines = _lines(capsys)
    assert [line["benchmark"] for line in lines] == [
        "matcher_hungarian_plain", "matcher_hungarian_kernel",
        "matcher_auction", "matcher_native_cpp_host",
        "train_detr_resnet_640", "train_panoptic_resnet_patchify8_640",
        "train_pretrainer_resnet_patchify8_640"]
    for line in lines[:4]:
        _check_line(line, "ms_per_solve")
        assert line["shape"] == [8, 32, 96] and line["steps_per_chunk"] == 2
    for line in lines[4:]:
        _check_line(line, "ms_per_step")
        assert line["batch_size"] == 8 and math.isfinite(line["loss"])
        assert line["images_per_sec"] == pytest.approx(
            8e3 / line["ms_per_step"])

    out = bench_torch.main({"BENCH_RES": "64", "BENCH_SET": TINY_SET},
                           "cpu", steps=1)
    assert json.loads(capsys.readouterr().out.strip()) == out
    assert {"metric", "value", "unit", "vs_baseline",
            "inference_images_per_sec_per_chip_64px", "train_step_ms",
            "final_loss", "batch_size", "model", "backbone", "device",
            "power_limit_w", "kernel_launches"} <= out.keys()
    assert out["metric"] == "train_images_per_sec_per_chip_64px"
    assert out["value"] == pytest.approx(8e3 / out["train_step_ms"])
    assert out["vs_baseline"] == pytest.approx(out["value"] / 8.0)
    assert math.isfinite(out["final_loss"]) and out["device"] == "cpu"


def test_no_card_no_fallback(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (rb.bench_matcher, lambda: rb.bench_throughput(True),
                rb.bench_other_models, bench_torch.main,
                lambda: profile_step.main(["--steps", "1"]),
                lambda: rb.main(["--quick"])):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            run()
    assert capsys.readouterr().out == ""


# Kernel names from profiles of the 640 flagship's train step and of the
# 1280 one with the fused attention (profile_step.py), the resident wide
# forward from vit_l16_h4's (chip_smoke.py) and the wgmma forward from a
# profile of attention_fwd at vit_h16's head dim, D = 80, on an NVIDIA
# H100 80GB HBM3, torch 2.11.0+cu128, with the category each belongs to (the
# library's names cut at 200 characters, as the profile prints them).
CHIP_KERNELS = {
    "void (anonymous namespace)::patchify_fwd_mma_kernel<5, 2, "
    "__nv_bfloat16>(float const*, __nv_bfloat16 const*, __nv_bfloat16*, "
    "int, int, int, int, int, int, int, int, int, int, int)": "K1-fwd",
    "(anonymous namespace)::patchify_dw_mma_kernel(float const*, "
    "__nv_bfloat16 const*, float*, int, int, int, int, int, int, int, int, "
    "int, int, int, int)": "K1-dW",
    "void (anonymous namespace)::patchify_partials_sum_kernel<"
    "__nv_bfloat16>(float const*, int, int, float*, __nv_bfloat16*)":
        "K1-dW",
    "void (anonymous namespace)::lap_kernel<5, 1>(float const*, int const*, "
    "float*, int, int, int)": "K2",
    "void (anonymous namespace)::attn_fwd_mma_kernel<32>(__nv_bfloat16 "
    "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, "
    "float*, int, int, int, float)": "K3-fwd",
    "void (anonymous namespace)::attn_fwd_wide_mma_kernel<2>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, int, int, int, "
    "float)": "K3-fwd",
    "void (anonymous namespace)::attn_fwd_wgmma_kernel<80>(CUtensorMap_st, "
    "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, float*, int, int, int, "
    "float)": "K3-fwd",
    "void (anonymous namespace)::attn_dq_mma_kernel<32>(__nv_bfloat16 "
    "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 "
    "const*, float const*, float const*, __nv_bfloat16*, int, int,": "K3-dq",
    "void (anonymous namespace)::attn_dkdv_mma_kernel<32>(__nv_bfloat16 "
    "const*, __nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 "
    "const*, float const*, float const*, __nv_bfloat16*, __nv_": "K3-dkdv",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel"
    "__5x_cudnn": "cuDNN convolution",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_"
    "nhwc_tilesize128x64x64_warpgroupsize1x1x1_g1_execute_segment_k_off_"
    "kernel__5x_cudnn": "cuDNN convolution",
    "sm90_xmma_dgrad_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_"
    "tilesize256x128x64_warpgroupsize2x1x1_g1_execute_segment_k_off":
        "cuDNN convolution",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_"
    "warpsize1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas":
        "CUDA-core GEMM",
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nn_align1>("
    "cutlass_80_simt_sgemm_128x32_8x5_nn_align1::Params)": "CUDA-core GEMM",
    "nvjet_tst_128x160_64x5_2x1_v_ssched_bz_TNT": "tensor-core GEMM",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "128x64_64x6_nt_align8>(cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_"
    "128x64_64x6_nt_align8::Params)": "tensor-core GEMM",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16, "
    "float, __nv_bfloat16, false, __nv_bfloat16, __nv_bfloat16, "
    "__nv_bfloat16, true, false, false, false>(cublasLt::":
        "tensor-core GEMM",
    "Memcpy DtoD (Device -> Device)": "copies",
    "Memset (Device)": "copies",
    "void at::native::vectorized_elementwise_kernel<8, at::native::"
    "bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}, "
    "std::array<char*, 2ul> >(int, at::native::bfloat16_copy_ke": "copies",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native"
    "::(anonymous namespace)::OpaqueType<4u>, unsigned int, 3, 64, 64>(at::"
    "native::(anonymous namespace)::OpaqueType<4u>*, at:": "copies",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float, "
    "at::native::MeanOps<float, float, float, float>, unsigned int, float, "
    "4, 4> >(at::native::ReduceOp<float, at::native::Mea": "reduction",
    "void (anonymous namespace)::softmax_warp_backward<float, float, float, "
    "9, false, false>(float*, float const*, float const*, int, int, int, "
    "bool const*)": "reduction",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::"
    "CUDAFunctor_add<float>, std::array<char*, 3ul>)": "elementwise",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::"
    "native::(anonymous namespace)::TensorListMetadata<2>, at::native::"
    "(anonymous namespace)::BinaryOpListAlphaFunctor<float, 2": "other",
}


@pytest.mark.parametrize("name,category", sorted(CHIP_KERNELS.items()))
def test_categorize_chip_kernel_names(name, category):
    assert profile_step.categorize(name) == category


def test_profile_attributes_every_component_on_the_cpu():
    env = {"BENCH_RES": "64", "BENCH_SET": TINY_SET}
    prof, wall, side = profile_step.run_profiled(2, 1, False, "cpu", env)
    assert side == 64 and wall > 0
    # each operator's own host time stands in for the card's kernels
    events = prof.events()
    rows = profile_step.attribute(
        events, profile_step.resolutions(side),
        units=[(e.name, e.self_cpu_time_total, e) for e in events
               if e.self_cpu_time_total])
    seen = {(r["component"], r["phase"]) for r in rows}
    for comp in ("backbone", "neck", "det_transformer", "heads"):
        assert (comp, "train_step/forward") in seen, comp
        assert (comp, "train_step/backward") in seen, comp
    assert ("matcher", "train_step/loss_and_matching") in seen
    assert ("match_costs+loss", "train_step/backward") in seen
    assert ("optimizer", "train_step/optimizer") in seen
    convs = {(r["resolution"], r["phase"]) for r in rows
             if r["name"] == "aten::convolution_backward"}
    assert {(8, "train_step/backward"), (4, "train_step/backward"),
            (2, "train_step/backward")} <= convs


def _dense_flops(m, k, n):
    return 2 * m * k * n


def test_roofline_counts_a_bottleneck_block():
    from boosted_detr_torch.models.backbone import BottleneckBlock

    block = roofline._meta(BottleneckBlock(64, 256, 2, "batchnorm",
                                           torch.bfloat16))
    x = torch.empty(2, 8, 8, 64, device="meta", dtype=torch.bfloat16)
    row = roofline.train_count(block, block, x)
    m = 2 * 4 * 4  # stride 2: 4x4 outputs
    fwd = (_dense_flops(2 * 8 * 8, 64, 64)      # 1x1 reduce at 8x8
           + _dense_flops(m, 9 * 64, 64)        # 3x3, stride 2
           + _dense_flops(m, 64, 256)           # 1x1 expand
           + _dense_flops(m, 64, 256))          # projection, stride 2
    # forward, the input's gradient and the weights' gradient
    assert row["flops"] == {torch.bfloat16: 3 * fwd}
    n_params = sum(p.numel() for p in block.parameters())
    n_buffers = sum(b.numel() for b in block.buffers())
    assert row["bytes"] == (2 * x.numel() * 2 + 2 * 2 * 4 * 4 * 256 * 2
                            + 2 * 4 * n_params + 2 * 4 * n_buffers)
    attain, by = roofline.bound(row)
    assert by == "bytes" and attain == pytest.approx(
        row["bytes"] / roofline.HBM_BYTES_PER_S * 1e3)


def test_roofline_counts_an_attention_layer():
    from boosted_detr_torch.models.layers import MultiheadAttention

    b, t, d, h = 2, 10, 32, 4
    attn = roofline._meta(MultiheadAttention(d, h, torch.bfloat16))
    x = torch.empty(b, t, d, device="meta", dtype=torch.bfloat16)
    row = roofline.train_count(attn, lambda x: attn(x, x, x), x)
    projections = 4 * _dense_flops(b * t, d, d)             # q, k, v, out
    logits_and_pv = 2 * b * h * _dense_flops(t, d // h, t)  # float32
    assert row["flops"] == {torch.bfloat16: 3 * projections,
                            torch.float32: 3 * logits_and_pv}
    attain, by = roofline.bound(row)
    assert attain == pytest.approx(1e3 * max(
        3 * projections / 989e12 + 3 * logits_and_pv / 67e12,
        row["bytes"] / 3.35e12))
