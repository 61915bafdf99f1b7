"""The hand-written CUDA kernels of the fused attention
(boosted_detr_torch/csrc/attention.cu: K3's forward with the lse, dq and
dk/dv; bfloat16 inputs on the tensor cores, float32 inputs on the CUDA
cores but the forward at a padded D = 256 and 384 and dq and dk/dv at a
padded D = 256 on the tensor cores as three TF32 products a product)
against their plain PyTorch versions on the
card, the tensor-core kernels against the plain PyTorch emulation of
their arithmetic, the
autograd ``FusedAttentionFn`` on the card against its CPU route, the
kernels' repeatability bit for bit, ViT artifacts at head dims 80 and
256 that keep the forward op, and the refusal of a misaligned bfloat16
tensor. Head dims 32, 64, 80 (ViT-Huge's, with no padded copy) and 128
run as built, in bf16 the forward, dq and dk/dv at all four on the wgmma
kernels (the forward at D <= 64 in blocks of one warpgroup; dq and dk/dv
on mma.sync over short streams); 16, 48, 72 and 96 padded with zeros to
the next; past 128, multiples of 128 (256, 384, 512) run on the wide kernels and any
other D (160) padded to the next multiple: in bf16, the forward, dq and
dk/dv on the resident kernels up to D = 384 (the forward on wgmma with
TMA), on the chunked ones (128-wide chunks) from 512 on. It needs a CUDA
card and nvcc, and skips without a card. It imports nothing of JAX, so
that it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_attention_kernel.py
"""

import numpy as np
import pytest
import torch

from boosted_detr_torch.ops import attention as ta

torch.set_num_threads(2)

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, bh, tq, tk, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(
        np.float32)).to(cuda, _DT[dtype]) for t in (tq, tk, tk, tq))
    g_lse = torch.from_numpy(rng.standard_normal((bh, tq)).astype(
        np.float32)).to(cuda)
    return q, k, v, g, g_lse


def _assert_close(got, want, dtype, grad=False):
    """float32: the same float32 formulas summed in other orders (the
    kernels' 64-row tiles and 16-key chunks against cuBLAS), a few ulps of
    the sums. bfloat16: those sums, then one rounding of the result, one
    bf16 ulp (2**-7 relative); a gradient also inherits the one-ulp
    differences of the bf16 output through delta, held to 1e-4 of the
    largest value."""
    scale = want.float().abs().max().item()
    if dtype == "float32":
        atol, rtol = 1e-5 * max(scale, 1.0), 1e-4
    else:
        atol, rtol = (1e-4 if grad else 1e-5) * max(scale, 1.0), 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,tq,tk,d", [
    (4, 1600, 1600, 32),  # the 1280px encoder, 4 of its 64 heads
    (4, 96, 1600, 32),    # the 1280px cross-attention
    (4, 1600, 1600, 64),  # the ViT-p16 blocks, 4 of their 48 heads
    (3, 300, 520, 64),    # ragged: partial tiles of both
    (2, 17, 1000, 32),    # a tiny query, a partial key tile
    (2, 96, 96, 32),      # the decoder self-attention
    # lengths that are no multiples of the 16-row step or the 64-row tile
    (3, 1, 300, 32), (3, 300, 1, 64), (3, 17, 17, 64), (3, 96, 520, 64),
    (3, 520, 17, 32), (3, 1, 1, 32), (3, 300, 96, 32), (3, 520, 300, 64),
    # head dims padded with zeros to 64 and 32 (encoder_dim=384 over 8
    # heads: D = 48)
    (4, 400, 400, 48), (3, 96, 520, 48), (3, 130, 200, 16),
    # D = 128 (vit_w512_h4) and ViT-Huge's D = 80, both as built (bf16
    # forward, dq and dk/dv on the wgmma kernels): 2 of vit_h16's 128
    # heads, ragged lengths, and 72 and 96 padded with zeros to 80 and 128
    (2, 1600, 1600, 80), (2, 1600, 1600, 128), (3, 300, 520, 128),
    (3, 96, 520, 80), (3, 1, 300, 128), (3, 300, 1, 80), (3, 17, 17, 128),
    (3, 520, 17, 80), (2, 130, 70, 80), (2, 130, 70, 128),
    (3, 130, 200, 72), (3, 130, 200, 96),
    # past 128: the wide kernels, D = 256 and 384 as they are, 160 padded
    # to 256 (vit_l16_h4's blocks: 2 of their 32 heads); in bf16 dq and
    # dk/dv on the resident kernels there, on the chunked ones at 512
    (2, 1600, 1600, 256), (3, 300, 520, 160), (3, 96, 520, 384),
    (3, 1, 300, 256), (3, 300, 1, 160), (3, 17, 17, 384), (3, 520, 17, 256),
    (3, 130, 70, 512), (2, 17, 300, 512),
])
def test_kernels_match_plain_versions(cuda, bh, tq, tk, d, dtype):
    q, k, v, g, g_lse = _inputs(cuda, bh, tq, tk, d, dtype)
    launches = (ta.attention_fwd.launches, ta.attention_dq.launches,
                ta.attention_dkdv.launches)
    out, lse = ta.attention_fwd(q, k, v)
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    _assert_close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)

    delta = (g.float() * want.float()).sum(-1) - g_lse
    dq = ta.attention_dq(q, k, v, g, want_lse, delta)
    dk, dv = ta.attention_dkdv(q, k, v, g, want_lse, delta)
    torch.cuda.synchronize()
    assert (ta.attention_fwd.launches, ta.attention_dq.launches,
            ta.attention_dkdv.launches) == tuple(n + 1 for n in launches)
    _assert_close(dq, ta.attention_dq_reference(q, k, v, g, want_lse,
                                                delta), dtype, grad=True)
    want_dk, want_dv = ta.attention_dkdv_reference(q, k, v, g, want_lse,
                                                   delta)
    _assert_close(dk, want_dk, dtype, grad=True)
    _assert_close(dv, want_dv, dtype, grad=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 80, 128, 160, 256, 384])
def test_function_gradients_on_the_card_match_the_cpu_route(cuda, dtype, d):
    q, k, v, g, g_lse = _inputs(cuda, 2, 130, 200, d, dtype, seed=1)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out, lse = ta.fused_attention_with_lse(*leaves)
        torch.autograd.backward([out, lse], [g.to(dev), g_lse.to(dev)])
        grads[dev] = [out, lse] + [t.grad for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got.abs().sum() > 0
        _assert_close(got.cpu(), want, dtype, grad=True)


def _gradient_args(cuda, bh, tq, tk, d, dtype, seed):
    """(q, k, v, g, lse, delta) with the plain forward's lse and a delta
    that holds a cotangent of the lse."""
    q, k, v, g, g_lse = _inputs(cuda, bh, tq, tk, d, dtype, seed)
    out, lse = ta.attention_fwd_reference(q, k, v)
    return q, k, v, g, lse, (g.float() * out.float()).sum(-1) - g_lse


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,tq,tk,d", [(8, 1600, 1600, 64),
                                        (5, 300, 520, 32),
                                        (4, 1600, 1600, 80),
                                        (5, 300, 520, 128),
                                        (2, 1600, 1600, 256),
                                        (3, 300, 520, 384),
                                        (3, 300, 520, 512)])
def test_gradient_kernels_repeat_bit_for_bit(cuda, bh, tq, tk, d, dtype):
    """No atomics and a fixed summation order: two launches on the same
    inputs give the same bits."""
    args = _gradient_args(cuda, bh, tq, tk, d, dtype, seed=2)
    first = (ta.attention_dq(*args), *ta.attention_dkdv(*args))
    torch.cuda.synchronize()
    second = (ta.attention_dq(*args), *ta.attention_dkdv(*args))
    for a, b in zip(first, second):
        assert a.abs().sum() > 0
        assert torch.equal(a, b)


def _kernel_names(*calls):
    """Names of the device kernels of the attention that ``calls`` launch,
    from a profile in this process. The tests below take theirs from a
    process of their own (``_profiled``): once an earlier profile has run
    in a process, as another test file's may under one pytest, a later one
    can record no device kernel at all."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "attn_" in e.key]


def _gradient_kernel_names(args):
    """Names of the device kernels that one dq and one dk/dv call launch."""
    return _kernel_names(lambda: ta.attention_dq(*args),
                         lambda: ta.attention_dkdv(*args))


def _recorded(names_of, launched):
    """``names_of()``, taken again (three times at most) while it records
    fewer kernels than the ``launched`` ones: a profile of the gradients'
    two launches once recorded dk/dv's alone."""
    for _ in range(3):
        names = names_of()
        if len(names) >= launched:
            break
    return names


# (Tq, Tk) of the profiled gradients: streams past SHORT_STREAM rows, and
# at D <= 64 (dq over 96 keys, dk/dv over 96 queries) short ones too
PROFILED_GRADIENTS = {"grad": (200, 330), "grad_short": (96, 96)}
# (Tq, Tk) of the profiled forwards: streams of several key tiles, over
# 200 queries and the decoder's 96, and at D <= 64 one key tile
PROFILED_FORWARDS = {"fwd": (200, 330), "fwd_short": (96, 330),
                     "fwd_one_tile": (200, 50)}


def profiled_names(d):
    """{kind: {dtype: names}} of the forward and of the gradient kernels
    at head dim ``d`` and the inputs of the tests below, each built and
    loaded before its profile."""
    cuda = torch.device("cuda")
    out = {}
    for dtype in ("float32", "bfloat16"):
        for kind, (tq, tk) in PROFILED_FORWARDS.items():
            if kind != "fwd" and d > 64:
                continue
            qkv = _inputs(cuda, 3, tq, tk, d, dtype, seed=3)[:3]
            ta.attention_fwd(*qkv)
            out.setdefault(kind, {})[dtype] = _recorded(
                lambda: _kernel_names(lambda: ta.attention_fwd(*qkv)), 1)
        for kind, (tq, tk) in PROFILED_GRADIENTS.items():
            if kind == "grad_short" and d > 64:
                continue
            args = _gradient_args(cuda, 3, tq, tk, d, dtype, seed=3)
            ta.attention_dq(*args)
            ta.attention_dkdv(*args)
            out.setdefault(kind, {})[dtype] = _recorded(
                lambda: _gradient_kernel_names(args), 2)
    return out


PROFILED_DIMS = (32, 64, 80, 128, 160, 256, 384, 512)


@pytest.fixture(scope="module")
def _profiled():
    """``profiled_names`` at ``PROFILED_DIMS``, from a new Python
    process."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve()
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_attention_kernel as t; "
            "print(json.dumps({d: t.profiled_names(d) "
            "for d in t.PROFILED_DIMS}))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parents[1]), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code, str(here.parent)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {int(d): v for d, v in json.loads(
        proc.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
def test_float32_forward_stays_on_the_cuda_cores(cuda, _profiled, d):
    """float32 inputs take the float32 forward (one TF32 or bf16 pass of
    the tensor cores would lose float32's accuracy) and keep its float32
    accuracy: on the CUDA cores, but at D = 256 on the tensor cores as
    three TF32 products a product (``attn_fwd_wide_tf32_kernel``);
    bfloat16 inputs take the tensor-core forward; past D = 128 the wide
    ones."""
    inputs = {dtype: _inputs(cuda, 3, 200, 330, d, dtype, seed=3)[:3]
              for dtype in ("float32", "bfloat16")}
    names = _profiled[d]["fwd"]
    wide = "wide_" if d > 128 else ""
    assert len(names["float32"]) == len(names["bfloat16"]) == 1, names
    f32 = (ta.wide_forward_kernel(d, torch.float32) if wide
           else "attn_fwd_kernel")
    assert f32 == ("attn_fwd_wide_tf32_kernel" if d == 256
                   else "attn_fwd_kernel"), f32
    # both are templates: the name is followed by its arguments
    assert f"{f32}<" in names["float32"][0], names
    tensor_core = (ta.wide_forward_kernel(d) if wide
                   else ta.narrow_forward_kernel(d))
    assert tensor_core in names["bfloat16"][0], names
    out, lse = ta.attention_fwd(*inputs["float32"])
    want, want_lse = ta.attention_fwd_reference(*inputs["float32"])
    # a few float32 ulps of sums over 330 keys; one bf16 or TF32 rounding
    # of an operand would be 1e-3 of a term
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64, 80, 128, 256])
def test_float32_gradients_stay_on_the_cuda_cores(cuda, _profiled, d):
    """float32 inputs take the float32 kernels and keep their float32
    accuracy: on the CUDA cores, but at D = 256 on the tensor cores as
    three TF32 products a product (``attn_dq_wide_tf32_kernel``,
    ``attn_dkdv_wide_tf32_kernel``; one TF32 or bf16 rounding of an
    operand would leave the gates below); bfloat16 inputs take the
    bf16 tensor-core kernels."""
    args = {dtype: _gradient_args(cuda, 3, 200, 330, d, dtype, seed=3)
            for dtype in ("float32", "bfloat16")}
    names = _profiled[d]["grad"]
    assert len(names["float32"]) == len(names["bfloat16"]) == 2, names
    if d == ta.TF32_HEAD_DIM:
        for name in ta.wide_gradient_kernels(d, torch.float32):
            assert sum(f"{name}(" in n for n in names["float32"]) == 1, names
    else:
        assert not any("mma" in n or "tf32" in n
                       for n in names["float32"]), names
    assert all("mma" in n for n in names["bfloat16"]), names
    assert all(("wide" in n) == (d > 128)
               for n in names["float32"] + names["bfloat16"]), names
    # a few float32 ulps of sums over 200-330 rows; one bf16 or TF32
    # rounding of an operand would be 1e-3 of a term
    got = (ta.attention_dq(*args["float32"]),
           *ta.attention_dkdv(*args["float32"]))
    want = (ta.attention_dq_reference(*args["float32"]),
            *ta.attention_dkdv_reference(*args["float32"]))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 256, 384, 512])
def test_head_dims_past_128_launch_the_wide_kernels(cuda, dtype, d):
    """Head dims over 128 launch the kernels (160 padded with zeros to
    256): one launch each of the forward, dq and dk/dv through
    ``FusedAttentionFn``, inside the gates against the plain versions."""
    q, k, v, g, g_lse = _inputs(cuda, 2, 130, 200, d, dtype, seed=8)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (ta.attention_fwd.launches, ta.attention_dq.launches,
              ta.attention_dkdv.launches)
    out, lse = ta.fused_attention_with_lse(*leaves)
    torch.autograd.backward([out, lse], [g, g_lse])
    torch.cuda.synchronize()
    assert (ta.attention_fwd.launches, ta.attention_dq.launches,
            ta.attention_dkdv.launches) == tuple(n + 1 for n in before)
    assert out.shape == (2, 130, d)
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    _assert_close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    delta = (g.float() * out.detach().float()).sum(-1) - g_lse
    args = (q, k, v, g, lse.detach(), delta)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    for got, ref in ((leaves[0].grad, ta.attention_dq_reference(*args)),
                     (leaves[1].grad, want_dk), (leaves[2].grad, want_dv)):
        assert got.shape == ref.shape == (2, got.shape[1], d)
        _assert_close(got, ref, dtype, grad=True)


@pytest.mark.gpu
@pytest.mark.parametrize("d,route", [(160, ""), (256, ""), (384, ""),
                                     (512, "chunked_")])
def test_wide_gradients_launch_their_route(cuda, _profiled, d, route):
    """Past D = 128 the bf16 dq and dk/dv run the resident kernels up to
    D = 384 (160 padded to 256) and the chunked ones from 512 on, by name
    from a profile; float32 takes the TF32 kernels at a padded 256 and
    keeps its CUDA-core wide kernels at 384 and 512."""
    names = _profiled[d]["grad"]
    assert len(names["bfloat16"]) == 2, names
    f32_route = "tf32_" if ta.padded_head_dim(d) == ta.TF32_HEAD_DIM else ""
    for kind, name, f32_name in zip(
            ("dq", "dkdv"), ta.wide_gradient_kernels(d),
            ta.wide_gradient_kernels(d, torch.float32)):
        assert name == f"attn_{kind}_wide_{route}mma_kernel"
        # a template's name is followed by its arguments, a plain one's by (
        assert sum(any(f"{name}{c}" in n for c in "<(")
                   for n in names["bfloat16"]) == 1, names
        assert f32_name == f"attn_{kind}_wide_{f32_route}kernel"
        assert sum(f"{f32_name}(" in n for n in names["float32"]) == 1, names


@pytest.mark.gpu
@pytest.mark.parametrize("d,profile,routes", [
    (32, "grad", ("wgmma", "wgmma")), (64, "grad", ("wgmma", "wgmma")),
    (80, "grad", ("wgmma", "wgmma")), (128, "grad", ("wgmma", "wgmma")),
    (32, "grad_short", ("mma", "mma")), (64, "grad_short", ("wgmma", "mma"))])
def test_narrow_gradients_launch_their_kernels(cuda, _profiled, d, profile,
                                               routes):
    """Up to D = 128 the bf16 dq and dk/dv run the wgmma kernels (TMA,
    the block's rows resident) at every built D, 32, 64, 80 and 128, but
    over streams of at most ``SHORT_STREAM`` rows the ``mma.sync`` ones
    for dq at D = 32 and for dk/dv at 32 and 64, by name from a profile,
    as ``narrow_gradient_kernels`` names them (``routes``: dq's, dk/dv's);
    float32 keeps its CUDA-core kernels."""
    names = _profiled[d][profile]
    assert len(names["bfloat16"]) == 2, names
    for kind, route, name in zip(("dq", "dkdv"), routes,
                                 ta.narrow_gradient_kernels(
                                     d, *PROFILED_GRADIENTS[profile])):
        assert name == f"attn_{kind}_{route}_kernel"
        # a template's name is followed by its arguments
        assert sum(f"{name}<{d}>" in n for n in names["bfloat16"]) == 1, names
        assert sum(f"attn_{kind}_kernel<" in n
                   for n in names["float32"]) == 1, names


@pytest.mark.gpu
@pytest.mark.parametrize("d,route", [(32, "wgmma"), (64, "wgmma"),
                                     (80, "wgmma"), (128, "wgmma")])
def test_narrow_forward_launches_its_kernel(cuda, _profiled, d, route):
    """Up to D = 128 the bf16 forward runs ``attn_fwd_wgmma_kernel``
    (wgmma, TMA, q resident; ``route``; at D <= 64 in blocks of one
    warpgroup, over several key tiles or one, 200 queries or the decoder's
    96), by name from a profile in a fresh process, as
    ``narrow_forward_kernel`` names it; float32 keeps its CUDA-core
    kernel."""
    for kind in PROFILED_FORWARDS:
        if kind != "fwd" and d > 64:
            continue
        names = _profiled[d][kind]
        assert len(names["bfloat16"]) == len(names["float32"]) == 1, names
        name = ta.narrow_forward_kernel(d)
        assert name == f"attn_fwd_{route}_kernel"
        # a template's name is followed by its arguments
        assert f"{name}<{d}>" in names["bfloat16"][0], names
        assert "attn_fwd_kernel<" in names["float32"][0], names


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dim_80_runs_without_a_padded_copy(cuda, monkeypatch, dtype):
    """ViT-Huge's D = 80 runs at its true width: the forward, dq and
    dk/dv launch once each with no ``F.pad`` (which would raise here) and
    no slice, and hold their plain versions' gates."""
    def refused(*args, **kwargs):
        raise AssertionError("F.pad called at D = 80")

    q, k, v, g, g_lse = _inputs(cuda, 3, 130, 200, 80, dtype, seed=9)
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    delta = (g.float() * want.float()).sum(-1) - g_lse
    args = (q, k, v, g, want_lse, delta)
    before = (ta.attention_fwd.launches, ta.attention_dq.launches,
              ta.attention_dkdv.launches)
    monkeypatch.setattr(torch.nn.functional, "pad", refused)
    assert ta.padded_head_dim(80) == 80
    out, lse = ta.attention_fwd(q, k, v)
    dq = ta.attention_dq(*args)
    dk, dv = ta.attention_dkdv(*args)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert (ta.attention_fwd.launches, ta.attention_dq.launches,
            ta.attention_dkdv.launches) == tuple(n + 1 for n in before)
    for got in (out, dq, dk, dv):
        assert got.shape[-1] == 80 and got.is_contiguous()
    _assert_close(out, want, dtype)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    for got, ref in ((dq, ta.attention_dq_reference(*args)), (dk, want_dk),
                     (dv, want_dv)):
        _assert_close(got, ref, dtype, grad=True)


@pytest.mark.gpu
@pytest.mark.parametrize("d,route", [(160, ""), (256, ""), (384, ""),
                                     (512, "chunked_")])
def test_wide_forward_launches_its_route(cuda, _profiled, d, route):
    """Past D = 128 the bf16 forward runs the resident kernel
    (``attn_fwd_wide_mma_kernel<NC>``: wgmma, TMA, q resident) up to
    D = 384 (160 padded to 256) and the chunked one from 512 on, by name
    from a profile; float32 runs the TF32 kernel
    (``attn_fwd_wide_tf32_kernel<D>``) at a padded 256 and 384 and keeps
    its CUDA-core wide kernel from 512 on."""
    names = _profiled[d]["fwd"]
    assert len(names["bfloat16"]) == len(names["float32"]) == 1, names
    name = ta.wide_forward_kernel(d)
    assert name == f"attn_fwd_wide_{route}mma_kernel"
    # a template's name is followed by its arguments, a plain one's by (
    assert f"{name}{'(' if route else '<'}" in names["bfloat16"][0], names
    padded = ta.padded_head_dim(d)
    f32 = ta.wide_forward_kernel(d, torch.float32)
    if padded in ta.TF32_FORWARD_HEAD_DIMS:
        assert f32 == "attn_fwd_wide_tf32_kernel"
        assert f"{f32}<{padded}>" in names["float32"][0], names
    else:
        assert f32 == "attn_fwd_wide_kernel"
        assert f"{f32}(" in names["float32"][0], names


@pytest.mark.gpu
def test_misaligned_tensor_raises(cuda):
    """The tensor-core kernels copy rows 16 bytes at a time: a contiguous
    bfloat16 view that starts 2 bytes into its storage is refused by the
    forward, dq and dk/dv, not read out of line. The float32 kernels read
    value by value and take such a view."""
    args = _gradient_args(cuda, 2, 8, 8, 32, "bfloat16", seed=4)
    flat = torch.zeros(2 * 8 * 32 + 8, dtype=torch.bfloat16, device=cuda)
    q = flat[1:1 + 2 * 8 * 32].view(2, 8, 32).copy_(args[0])
    assert q.is_contiguous() and q.data_ptr() % 16
    before = (ta.attention_fwd.launches, ta.attention_dq.launches,
              ta.attention_dkdv.launches)
    with pytest.raises(ValueError, match="aligned"):
        ta.attention_fwd(q, *args[1:3])
    with pytest.raises(ValueError, match="aligned"):
        ta.attention_fwd(args[0], args[1], q)  # 8 keys: v's shape too
    for kernel in (ta.attention_dq, ta.attention_dkdv):
        with pytest.raises(ValueError, match="aligned"):
            kernel(q, *args[1:])
    assert (ta.attention_fwd.launches, ta.attention_dq.launches,
            ta.attention_dkdv.launches) == before
    flat32 = torch.zeros(2 * 8 * 32 + 4, device=cuda)
    q32 = flat32[1:1 + 2 * 8 * 32].view(2, 8, 32).copy_(args[0])
    assert q32.data_ptr() % 16
    k32, v32 = args[1].float(), args[2].float()
    out, lse = ta.attention_fwd(q32, k32, v32)
    want, want_lse = ta.attention_fwd_reference(q32, k32, v32)
    _assert_close(out, want, "float32")
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


def _one_bf16_ulp(got, want):
    """The share of equal values, after checking that the others lie one
    bf16 ulp apart (2**-7 relative at most) or, where a sum cancels, within
    1e-5 of the largest value: a tenth of what the plain versions' gate
    allows."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=2.0 ** -7,
                               atol=1e-5 * want.abs().max().item())
    return (got == want).float().mean().item()


def _emulated(emulation, q, k, v, *rest):
    """``emulation`` as the kernels run it: on q, k and v (and g) padded
    with zeros to the built head dim, with the true 1/sqrt(D), sliced
    back."""
    d = q.shape[-1]
    padded = ta._padded(q, k, v, *rest[:1])
    out = emulation(*padded, *rest[1:], scale=ta._scale(d))
    return tuple(t[..., :d] if t.dim() == 3 else t for t in out)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,d", [
    (3, 300, 520, 64), (3, 17, 1000, 32),  # ragged
    # the edges of TMA's zero fill at D <= 64: one query, one key, both
    # under a 16-row step (where the stream is short, the mma.sync
    # kernels), and one row past SHORT_STREAM in the streamed operand
    (3, 1, 300, 32), (3, 300, 1, 64), (3, 17, 17, 64), (3, 17, 129, 64),
    (3, 129, 17, 32),
    (4, 1600, 1600, 32), (4, 1600, 1600, 64), (4, 96, 1600, 32),
    (3, 300, 520, 128), (3, 17, 1000, 80), (2, 1600, 1600, 80),
    (2, 1600, 1600, 128),
    # the wide kernels, resident (the block's rows staged once, 32-row
    # tiles) at D = 160, 256 and 384, ragged too, and chunked (128-wide
    # chunks, 32-query tiles in dk/dv) at 512
    (3, 300, 520, 256), (2, 1600, 1600, 256), (3, 17, 1000, 160),
    (3, 130, 70, 384), (3, 1, 300, 256), (3, 300, 1, 160), (3, 17, 17, 384),
    (3, 520, 17, 256), (3, 96, 520, 384), (3, 130, 70, 512)])
def test_tensor_core_kernels_match_their_emulation(cuda, bh, tq, tk, d):
    """The bfloat16 gradient kernels against the plain PyTorch emulation of
    their arithmetic (64-row tiles, p and ds as bf16 hi + lo, the scale at
    the end) on the same inputs, D = 80 at its true width as the kernels
    take it: what is left between them is the order of the float32 sums
    inside a tile and ex2.approx, so nearly every value is the same bf16
    and the rest its neighbour."""
    args = _gradient_args(cuda, bh, tq, tk, d, "bfloat16", seed=5)
    got = (ta.attention_dq(*args), *ta.attention_dkdv(*args))
    want = (*_emulated(lambda *a, **kw: (ta.attention_dq_emulation(*a, **kw),),
                       *args),
            *_emulated(ta.attention_dkdv_emulation, *args))
    shares = [_one_bf16_ulp(a, b) for a, b in zip(got, want)]
    print(f"equal to the emulation (dq, dk, dv): {shares}")
    assert min(shares) >= 0.99, shares


# The TF32 kernels against the emulation of their arithmetic: both take
# the same TF32 parts and sum the same products in the same order, but
# the tensor cores add into their float32 sums truncating (the products
# are exact), where the emulation rounds to nearest. Over S's and dP's
# chains of 96 adds a step of 8 dims, that is ~4e-5 of a dot product of
# unit-scale rows (a model of truncated adds on the CPU), and through
# dP - delta, which cancels where a row's keys are few, more of ds: held
# to 1e-4 of the largest value, as measured on the card (PERF.md).
TF32_EMULATION_GATE = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,d", [
    # ragged: no multiple of the 32-row tiles or the 64-row blocks, one
    # query, and 160 padded to 256; vit_l16_h4's blocks, 2 of 32 heads
    (3, 70, 130, 256), (3, 130, 70, 160), (3, 1, 130, 256),
    (3, 1, 300, 160), (3, 300, 520, 256), (3, 17, 1000, 160),
    (3, 520, 17, 256), (3, 33, 65, 256), (2, 1600, 1600, 256)])
def test_tf32_gradients_match_plain_and_emulation(cuda, bh, tq, tk, d):
    """float32 dq and dk/dv at a padded D = 256 (the TF32 kernels) inside
    the float32 gates against the plain versions and within
    ``TF32_EMULATION_GATE`` of the emulation of their arithmetic; a
    second launch gives the same bits, and each adds one to its
    wrapper's launches."""
    args = _gradient_args(cuda, bh, tq, tk, d, "float32", seed=9)
    before = (ta.attention_dq.launches, ta.attention_dkdv.launches)
    got = (ta.attention_dq(*args), *ta.attention_dkdv(*args))
    torch.cuda.synchronize()
    assert (ta.attention_dq.launches,
            ta.attention_dkdv.launches) == (before[0] + 1, before[1] + 1)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    for a, b in zip(got, (ta.attention_dq_reference(*args), want_dk,
                          want_dv)):
        _assert_close(a, b, "float32", grad=True)
    emulated = (*_emulated(
        lambda *a, **kw: (ta.attention_dq_emulation(*a, **kw),), *args),
        *_emulated(ta.attention_dkdv_emulation, *args))
    for a, b in zip(got, emulated):
        big = b.abs().max().item()
        print(f"off the emulation by {(a - b).abs().max().item() / big:.3e} "
              "of the largest value")
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=TF32_EMULATION_GATE * big)
    again = (ta.attention_dq(*args), *ta.attention_dkdv(*args))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,d", [
    # ragged against the 32-key tiles and the 64-row blocks, one query, one
    # key, both; 160 padded to 256, 300 to 384; vit_l16_h4's blocks (2 of
    # 32 heads) and the D = 384 row of chip_smoke.py
    (3, 70, 130, 256), (3, 130, 70, 160), (3, 1, 130, 256), (3, 130, 1, 384),
    (3, 1, 1, 256), (3, 300, 520, 384), (3, 17, 1000, 160),
    (3, 520, 17, 256), (3, 33, 65, 384), (3, 70, 130, 300),
    (2, 1600, 1600, 256), (3, 400, 400, 384)])
def test_tf32_forward_matches_plain_and_emulation(cuda, bh, tq, tk, d):
    """The float32 forward at a padded D = 256 and 384
    (``attn_fwd_wide_tf32_kernel``) inside the float32 gates against the
    plain version (out 1e-5 of the largest value / 1e-4, the lse 1e-5 /
    1e-5) and within ``TF32_EMULATION_GATE`` of the largest value of the
    emulation of its arithmetic (the lse within 1e-5); a second launch
    gives the same bits, and each adds one to ``attention_fwd.launches``."""
    q, k, v = _inputs(cuda, bh, tq, tk, d, "float32", seed=10)[:3]
    assert ta.padded_head_dim(d) in ta.TF32_FORWARD_HEAD_DIMS
    before = ta.attention_fwd.launches
    out, lse = ta.attention_fwd(q, k, v)
    again = ta.attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert ta.attention_fwd.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    _assert_close(out, want, "float32")
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    emu, emu_lse = _emulated(ta.attention_fwd_emulation, q, k, v)
    big = emu.abs().max().item()
    print(f"off the emulation by {(out - emu).abs().max().item() / big:.3e} "
          "of the largest value")
    torch.testing.assert_close(out, emu, rtol=0,
                               atol=TF32_EMULATION_GATE * big)
    torch.testing.assert_close(lse, emu_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_float32_function_at_256_runs_tf32_end_to_end(cuda):
    """A float32 ``FusedAttentionFn`` forward and backward at D = 256 runs
    the TF32 forward, dq and dk/dv (one launch each) and stays inside the
    float32 gates of the plain step (the plain forward, then the plain dq
    and dk/dv from its lse and delta)."""
    assert ta.wide_forward_kernel(256, torch.float32) == (
        "attn_fwd_wide_tf32_kernel")
    assert all("tf32" in n for n in ta.wide_gradient_kernels(
        256, torch.float32))
    q, k, v, g, g_lse = _inputs(cuda, 3, 300, 520, 256, "float32", seed=11)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (ta.attention_fwd.launches, ta.attention_dq.launches,
              ta.attention_dkdv.launches)
    out, lse = ta.fused_attention_with_lse(*leaves)
    torch.autograd.backward([out, lse], [g, g_lse])
    torch.cuda.synchronize()
    assert (ta.attention_fwd.launches, ta.attention_dq.launches,
            ta.attention_dkdv.launches) == tuple(n + 1 for n in before)
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    _assert_close(out, want, "float32")
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    args = (q, k, v, g, want_lse, (g * want).sum(-1) - g_lse)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    for got, ref in ((leaves[0].grad, ta.attention_dq_reference(*args)),
                     (leaves[1].grad, want_dk), (leaves[2].grad, want_dv)):
        _assert_close(got, ref, "float32", grad=True)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,d", [
    (3, 300, 520, 64), (3, 17, 1000, 32), (3, 1, 300, 32), (3, 300, 1, 64),
    (3, 17, 17, 64), (3, 96, 520, 64), (3, 520, 17, 32), (3, 1, 1, 32),
    (3, 520, 300, 32),  # ragged lengths 1, 17, 96, 300, 520, Tq != Tk
    (4, 1600, 1600, 32), (4, 1600, 1600, 64), (4, 96, 1600, 32),
    (4, 96, 96, 32),
    # D = 128 and D = 80 as built (wgmma, TMA, q resident), ragged too,
    # and 72 and 96 padded with zeros to them
    (3, 300, 520, 128), (3, 17, 1000, 80), (3, 1, 300, 128),
    (3, 520, 17, 80), (2, 1600, 1600, 80), (2, 1600, 1600, 128),
    (2, 130, 70, 80), (2, 130, 70, 128), (3, 130, 200, 72),
    (3, 130, 200, 96),
    # the wide forward: resident (wgmma, q staged once; 128 rows a block
    # at D = 256, 64 at 384), ragged too, and chunked at 512
    (3, 300, 520, 256), (2, 1600, 1600, 256), (3, 17, 1000, 160),
    (3, 1, 300, 384), (3, 520, 17, 256), (3, 130, 70, 384),
    (3, 17, 17, 384), (3, 130, 70, 512)])
def test_tensor_core_forward_matches_its_emulation(cuda, bh, tq, tk, d):
    """The bfloat16 forward against the plain PyTorch emulation of its
    arithmetic (64-key tiles, the scale inside the exponent, the float32 p
    summed into the denominator, p as bf16 hi + lo in P.V): nearly every
    value the same bf16, the rest its neighbour; the float32 lse within
    1e-5."""
    q, k, v = _inputs(cuda, bh, tq, tk, d, "bfloat16", seed=6)[:3]
    before = ta.attention_fwd.launches
    out, lse = ta.attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert ta.attention_fwd.launches == before + 1
    want, want_lse = _emulated(ta.attention_fwd_emulation, q, k, v)
    share = _one_bf16_ulp(out, want)
    print(f"equal to the emulation (out): {share}")
    assert share >= 0.99, share
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,tq,tk,d", [(8, 1600, 1600, 64),
                                        (5, 300, 520, 32),
                                        (4, 1600, 1600, 80),
                                        (5, 300, 520, 128),
                                        (2, 130, 70, 80),
                                        (2, 1600, 1600, 256),
                                        (3, 400, 400, 384)])
def test_forward_repeats_bit_for_bit(cuda, bh, tq, tk, d, dtype):
    """Every sum belongs to one thread and runs in a fixed order: two
    launches on the same inputs give the same bits."""
    q, k, v = _inputs(cuda, bh, tq, tk, d, dtype, seed=7)[:3]
    first = ta.attention_fwd(q, k, v)
    torch.cuda.synchronize()
    second = ta.attention_fwd(q, k, v)
    for a, b in zip(first, second):
        assert a.abs().sum() > 0
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bh,tq,tk,d", [
    # ragged lengths 17, 70, 130, 300 and 520 at D = 32, 48 (padded to 64)
    # and 64
    (3, 17, 70, 32), (3, 130, 520, 64), (3, 300, 17, 48), (3, 520, 130, 32),
    (3, 70, 300, 48), (3, 520, 300, 64),
    # one key tile and one key past it, over 256 and 257 queries, and a
    # single real key
    (3, 256, 64, 32), (3, 257, 64, 64), (3, 256, 65, 48), (3, 129, 17, 32),
    (3, 300, 1, 32), (3, 17, 1, 64), (3, 130, 1, 48),
    # the DETR decoder's and the 1280 encoder's, 2 of their heads
    (2, 96, 96, 32), (2, 96, 1600, 32), (2, 1600, 1600, 32),
    (2, 1600, 1600, 64)])
def test_narrow_forward_matches_plain_and_emulation(cuda, bh, tq, tk, d):
    """The bf16 forward at D <= 64 (``attn_fwd_wgmma_kernel`` in blocks of
    one warpgroup) against the plain version (one bf16 ulp over 1e-5; the
    lse within 1e-5) and the emulation of its arithmetic (at least 99.7%
    of the values equal, the others a neighbour: wgmma may sum inside a
    16-dim step otherwise than ``mma.sync``, whose order the emulation
    follows; the lse within 1e-5); a second launch gives the same bits,
    and each adds one to ``attention_fwd.launches``."""
    q, k, v = _inputs(cuda, bh, tq, tk, d, "bfloat16", seed=8)[:3]
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    emu, emu_lse = _emulated(ta.attention_fwd_emulation, q, k, v)
    before = ta.attention_fwd.launches
    out, lse = ta.attention_fwd(q, k, v)
    again = ta.attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert ta.attention_fwd.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    _assert_close(out, want, "bfloat16")
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    share = _one_bf16_ulp(out, emu)
    print(f"equal to the emulation (out): {share}")
    assert share >= 0.997, share
    torch.testing.assert_close(lse, emu_lse, atol=1e-5, rtol=1e-5)


# A bf16 ViT DETR whose blocks have width 160 over 2 heads: D = 80, which
# the forward op takes as built; the patch embed (P = 16 -> 160) takes the
# tensor-core K1, DETR's attentions D = 32. The same at width 256 over one
# head: D = 256, the wide kernels.
VIT_D80 = dict(image_size=(64, 64), backbone="vit_p16_d2_w160_h2",
               num_encoder_blocks=2, num_decoder_blocks=2, encoder_dim=64,
               decoder_dim=64, num_encoder_heads=2, num_decoder_heads=2,
               num_object_preds=16, num_categories=12, num_attributes=20,
               max_objects=8, compute_dtype="bfloat16", dropout_rate=0.0,
               use_pallas_stem=True, norm="batchnorm",
               use_pallas_attention=True)
# the op's launches a forward: 2 ViT blocks, 2 encoder blocks, 2
# cross-attentions and the second decoder block's self-attention
VIT_D80_LAUNCHES = 2 + 2 + 2 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("backbone,head_dim", [
    ("vit_p16_d2_w160_h2", 80),
    # one head of width 256: the wide kernels
    ("vit_p16_d2_w256_h1", 256)])
def test_exported_vit_artifact_keeps_the_op(cuda, tmp_path, backbone,
                                            head_dim):
    """The ViT at D = 80 and at D = 256 exported for cuda (serving.py): the
    loaded program keeps ``boosted_detr::attention_fwd`` at every
    attention, counts one launch each a forward, and equals the live model
    bit for bit."""
    import boosted_detr_torch as bt
    from boosted_detr_torch import serving
    from boosted_detr_torch.data.codec import TextCodec

    cfg = bt.ModelConfig(**dict(VIT_D80, backbone=backbone))
    model = bt.DETR(cfg, device=cuda, seed=1)
    assert dict(model.named_modules())[
        "backbone.vit.block_0.attn"].head_dim == head_dim
    codec = TextCodec({"category": [f"c{i}" for i in range(10)],
                       "attribute": [f"a{i}" for i in range(18)]})
    trainer = bt.Trainer(model, cfg, bt.TrainConfig(), codec=codec,
                         device="cuda").compile()
    serving.export_serving(trainer, str(tmp_path), platforms="cuda")
    served = serving.load_serving(str(tmp_path))
    ops = [str(n.target) for n in served.program.graph.nodes
           if str(n.target).startswith("boosted_detr.")]
    assert ops.count("boosted_detr.attention_fwd.default") == VIT_D80_LAUNCHES
    images = np.random.default_rng(2).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    want = bt.predict(model, images, decode_text=False)
    before = ta.attention_fwd.launches
    got = served(images, decode_text=False)
    torch.cuda.synchronize()
    assert ta.attention_fwd.launches - before == VIT_D80_LAUNCHES
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
