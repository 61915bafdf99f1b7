"""The hand-written CUDA kernels of the patchify stem
(boosted_detr_torch/csrc/patchify.cu: the forward, on the tensor cores for
bfloat16 weights and on the CUDA cores otherwise, and the weight gradient)
against their plain PyTorch versions on the card, and the stem's gradient
through ``PatchifyConvFn`` on the kernel route. It needs a CUDA card and
nvcc, and skips without a card. It imports nothing of JAX, so that it runs
on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_patchify_kernel.py
"""

import numpy as np
import pytest
import torch

from boosted_detr_torch.ops import patchify as tp

torch.set_num_threads(2)

_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# float32: only the order of the float32 sums differs. bfloat16: both sides
# round identical inputs and sum in float32, so the outputs differ by at
# most one rounding of the bf16 result, 2**-7 relative.
_TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
        "bfloat16": dict(atol=1e-5, rtol=2.0 ** -7)}


def _inputs(shape, patch, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    w = (rng.standard_normal((patch, patch, shape[-1], cout)) * 0.1).astype(
        np.float32)
    return x, w


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,patch,cout", [
    ((2, 640, 640, 3), 8, 128),   # the flagship stem
    ((1, 100, 84, 3), 8, 20),     # SAME padding, ragged channel slice
    ((1, 64, 64, 3), 16, 384),    # the ViT patch embed, narrowed slices
])
def test_kernel_matches_plain_version(cuda, shape, patch, cout, dtype):
    x, w = _inputs(shape, patch, cout)
    xt = torch.from_numpy(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda, _DT[dtype])
    before = tp.patchify_conv.launches
    out = tp.patchify_conv(xt, wt, clip01=True)
    torch.cuda.synchronize()
    assert tp.patchify_conv.launches == before + 1
    ref = tp.patchify_conv_reference(xt, wt, clip01=True)
    torch.testing.assert_close(out.float(), ref.float(), **_TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("w_dtype,out_dtype", [
    ("bfloat16", "float32"), ("float32", "bfloat16")])
@pytest.mark.parametrize("clip01", [True, False])
def test_kernel_mixed_dtypes_and_clip(cuda, w_dtype, out_dtype, clip01):
    x, w = _inputs((2, 64, 48, 3), 8, 64, seed=1)
    xt = torch.from_numpy(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda, _DT[w_dtype])
    out = tp.patchify_conv(xt, wt, out_dtype=_DT[out_dtype], clip01=clip01)
    ref = tp.patchify_conv_reference(xt, wt, out_dtype=_DT[out_dtype],
                                     clip01=clip01)
    assert out.dtype == _DT[out_dtype]
    # both sides round the input to the weights' dtype identically, so the
    # output dtype alone sets the tolerance
    torch.testing.assert_close(out.float(), ref.float(), **_TOL[out_dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,patch,cout,dtype", [
    # 16 float32 rows of 4096 x 3 values are 786 KB, over the 227 KB a
    # block may use: a block takes a span of the row's positions
    ((1, 16, 4096, 3), 16, 8, "float32"),
    ((2, 32, 4096, 3), 16, 384, "float32"),
    ((1, 8, 8192, 3), 4, 64, "float32"),    # 4 rows of 8192 x 3: 393 KB
    ((1, 8, 8192, 3), 4, 64, "bfloat16"),   # P = 4: the CUDA cores
    ((1, 20, 4100, 3), 16, 40, "float32"),  # SAME padding on a cut row
    ((1, 20, 4100, 3), 16, 40, "bfloat16"),
])
def test_kernel_takes_rows_that_do_not_fit(cuda, shape, patch, cout, dtype):
    x, w = _inputs(shape, patch, cout, seed=5)
    xt = torch.from_numpy(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda, _DT[dtype])
    assert tp.tensor_core_plan(shape, tuple(w.shape), _DT[dtype]) is None
    wo = -(-shape[2] // patch)
    cut = tp.fwd_span_plan(patch, 3, wo, cout, dtype == "bfloat16")
    assert cut.span < wo
    before = tp.patchify_conv.launches
    out = tp.patchify_conv(xt, wt, clip01=True)
    torch.cuda.synchronize()
    assert tp.patchify_conv.launches == before + 1
    ref = tp.patchify_conv_reference(xt, wt, clip01=True)
    torch.testing.assert_close(out.float(), ref.float(), **_TOL[dtype])


def _dw_case(cuda, shape, patch, cout, dtype, clip01, seed=2):
    x, _ = _inputs(shape, patch, cout, seed)
    ho, wo = -(-shape[1] // patch), -(-shape[2] // patch)
    g = np.random.default_rng(seed + 1).standard_normal(
        (shape[0], ho, wo, cout)).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda)
    # g arrives in the output dtype, which is the weights' on the stem
    gt = torch.from_numpy(g).to(cuda, _DT[dtype])
    return xt, gt


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,patch,cout", [
    ((2, 640, 640, 3), 8, 128),   # the flagship stem, batch 2
    ((1, 100, 84, 3), 8, 20),     # SAME padding, ragged channel tile
    ((2, 64, 48, 3), 4, 64),      # the patchify stem
    ((1, 64, 64, 3), 16, 384),    # the ViT patch embed: 12 k tiles, 3 n
])
def test_dw_kernel_matches_plain_version(cuda, shape, patch, cout, dtype):
    xt, gt = _dw_case(cuda, shape, patch, cout, dtype, clip01=True)
    before = tp.patchify_conv_dw.launches
    dw, dw32 = tp.patchify_conv_dw(xt, gt, patch, _DT[dtype], clip01=True)
    torch.cuda.synchronize()
    assert tp.patchify_conv_dw.launches == before + 1
    ref, ref32 = tp.patchify_conv_dw_reference(xt, gt, patch, _DT[dtype],
                                               clip01=True)
    assert dw.shape == ref.shape == (patch, patch, 3, cout)
    assert dw.dtype == _DT[dtype] and dw32.dtype == torch.float32
    # Both sum the same exact products of rounded values in float32, in
    # other orders (per-chunk partials against cuBLAS): the difference is
    # bounded by a few float32 ulps of the sum of the products' magnitudes.
    patches, _ = tp._patch_matrix(xt, patch, _DT[dtype], True)
    scale = (patches.float().abs().t()
             @ gt.reshape(-1, cout).to(_DT[dtype]).float().abs())
    bound = 1e-5 * scale.reshape(dw32.shape) + 1e-6
    assert ((dw32 - ref32).abs() <= bound).all()
    # the cast results then differ by at most one bf16 ulp where the two
    # sums straddle a rounding boundary: up to 2**-7 of the value
    assert ((dw.float() - ref.float()).abs()
            <= bound + 2.0 ** -7 * ref.float().abs()).all()


@pytest.mark.gpu
def test_dw_kernel_unclipped_f32_weights_bf16_g(cuda):
    xt, gt = _dw_case(cuda, (2, 64, 48, 3), 8, 64, "bfloat16", False)
    dw, dw32 = tp.patchify_conv_dw(xt, gt, 8, torch.float32, clip01=False)
    ref, ref32 = tp.patchify_conv_dw_reference(xt, gt, 8, torch.float32,
                                               clip01=False)
    assert dw.dtype == torch.float32
    torch.testing.assert_close(dw32, ref32, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(dw, ref, atol=1e-3, rtol=1e-5)


@pytest.mark.gpu
def test_stem_gradient_on_the_kernel_route(cuda):
    from boosted_detr_torch.models.backbone import PatchifyConv

    x, _ = _inputs((2, 64, 48, 3), 8, 32, seed=3)
    stem = PatchifyConv(3, 32, 8)
    cpu_x = torch.from_numpy(x)
    pre = (torch.tensor([2.0, 2.0, 2.0]), torch.tensor([-1.0, -1.0, -1.0]),
           None, True)
    stem(cpu_x, torch.float32, pre).square().sum().backward()
    want = stem.weight.grad.clone()
    stem.weight.grad = None
    stem.to(cuda)
    pre_cuda = (pre[0].to(cuda), pre[1].to(cuda), None, True)
    fwd, dw = tp.patchify_conv.launches, tp.patchify_conv_dw.launches
    out = stem(cpu_x.to(cuda), torch.float32, pre_cuda)
    assert out.grad_fn is not None
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert tp.patchify_conv.launches == fwd + 1
    assert tp.patchify_conv_dw.launches == dw + 1
    got = stem.weight.grad
    assert got is not None and got.abs().sum() > 0
    # float32 sums over 2*8*6 positions in other orders (cuBLAS, oneDNN,
    # the kernel): 1e-4 relative of gradients of size ~10
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,patch,cout", [
    # P=16 at W=4096: 3 staged rows of 12,288 values and a g row of 256 x
    # 128 are 278 KB, over the 227 KB a block may use: spans of the row
    ((1, 16, 4096, 3), 16, 8),
    ((1, 8, 8192, 3), 4, 64),
    ((1, 20, 4100, 3), 16, 40),  # SAME padding on a cut row
])
def test_dw_kernel_takes_rows_that_do_not_fit(cuda, shape, patch, cout,
                                              dtype):
    wo = -(-shape[2] // patch)
    assert tp.dw_span_plan(patch, 3, wo).span < wo
    xt, gt = _dw_case(cuda, shape, patch, cout, dtype, clip01=True, seed=6)
    if dtype == "bfloat16":  # float32 g keeps the CUDA-core kernel
        gt = gt.float()
    before = tp.patchify_conv_dw.launches
    dw, dw32 = tp.patchify_conv_dw(xt, gt, patch, _DT[dtype], clip01=True)
    torch.cuda.synchronize()
    assert tp.patchify_conv_dw.launches == before + 1
    ref, ref32 = tp.patchify_conv_dw_reference(xt, gt, patch, _DT[dtype],
                                               clip01=True)
    patches, _ = tp._patch_matrix(xt, patch, _DT[dtype], True)
    scale = (patches.float().abs().t()
             @ gt.reshape(-1, cout).to(_DT[dtype]).float().abs())
    bound = 1e-5 * scale.reshape(dw32.shape) + 1e-6
    assert ((dw32 - ref32).abs() <= bound).all()
    assert ((dw.float() - ref.float()).abs()
            <= bound + 2.0 ** -7 * ref.float().abs()).all()


@pytest.mark.gpu
def test_library_states_the_span_plans(cuda):
    """The C source's shared-memory counts are the plans' (the CPU tests
    hold the plans against the source's text)."""
    lib = tp._library()
    for p, c_in, wo, c_out, w_bf16 in ((8, 3, 80, 128, False),
                                       (16, 3, 256, 384, False),
                                       (4, 3, 2048, 64, True),
                                       (16, 3, 257, 40, False)):
        cut = tp.fwd_span_plan(p, c_in, wo, c_out, w_bf16)
        assert lib.patchify_smem_bytes(p, c_in, cut.span, cut.channels,
                                       int(w_bf16)) == cut.smem
        cut = tp.dw_span_plan(p, c_in, wo)
        assert lib.patchify_dw_smem_bytes(p, c_in, cut.span) == cut.smem


def _kernel_names(call, tag):
    """Names of the device kernels with ``tag`` in their name that ``call``
    launches, from a profile (one that recorded nothing is taken again,
    twice)."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=activities) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and tag in e.key]
        if names:
            break
    return names


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,patch,cout", [
    ((8, 640, 640, 3), 8, 128),     # the flagship stem
    ((2, 1280, 1280, 3), 8, 128),   # the 1280px stem: two segments a row
    ((8, 640, 640, 3), 16, 384),    # the ViT patch embed: Wo = 40, two rows
    ((3, 80, 640, 3), 16, 200),     # a ragged N: 200 of a block's 384
    ((1, 48, 40, 3), 8, 72),        # 30 positions in one block, N = 72
    ((5, 24, 1600, 3), 8, 8),       # Wo = 200: segments of 67, 67 and 66
    ((2, 32, 32, 4), 8, 520),       # P * C_in = 32: slabs straddle rows
])
def test_tensor_core_forward(cuda, shape, patch, cout, out_dtype):
    """bfloat16 weights where the patch divides the image take the
    tensor-core kernel. bf16 x bf16 products are exact in float32, so only
    the order of the float32 sums differs from the plain version; the
    result is held to one rounding of the output dtype."""
    x, w = _inputs(shape, patch, cout, seed=4)
    xt = torch.from_numpy(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda, torch.bfloat16)
    assert tp.tensor_core_plan(xt.shape, wt.shape, wt.dtype) is not None

    def call():
        return tp.patchify_conv(xt, wt, out_dtype=_DT[out_dtype], clip01=True)

    out = call()
    torch.cuda.synchronize()
    names = _kernel_names(call, "patchify_fwd")
    assert len(names) == 1 and "patchify_fwd_mma_kernel" in names[0], names
    ref = tp.patchify_conv_reference(xt, wt, out_dtype=_DT[out_dtype],
                                     clip01=True)
    assert out.dtype == _DT[out_dtype] and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), **_TOL[out_dtype])
    assert torch.equal(out, call())  # a fixed order of sums: the same bits
    # without the clip the image is only rounded
    torch.testing.assert_close(
        tp.patchify_conv(xt, wt, out_dtype=_DT[out_dtype]).float(),
        tp.patchify_conv_reference(xt, wt, out_dtype=_DT[out_dtype]).float(),
        **_TOL[out_dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,patch,cout,dtype", [
    ((2, 640, 640, 3), 8, 128, "float32"),  # float32 weights
    ((2, 64, 48, 3), 4, 64, "bfloat16"),    # P * C_in = 12: the patchify stem
    ((1, 100, 84, 3), 8, 24, "bfloat16"),   # SAME padding
    ((1, 64, 64, 3), 8, 20, "bfloat16"),    # N no multiple of 8
])
def test_other_inputs_keep_the_cuda_core_kernel(cuda, shape, patch, cout,
                                                dtype):
    x, w = _inputs(shape, patch, cout, seed=5)
    xt = torch.from_numpy(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda, _DT[dtype])
    assert tp.tensor_core_plan(xt.shape, wt.shape, wt.dtype) is None
    tp.patchify_conv(xt, wt, clip01=True)  # built and loaded
    names = _kernel_names(
        lambda: tp.patchify_conv(xt, wt, clip01=True), "patchify_fwd")
    assert len(names) == 1 and "patchify_fwd_kernel" in names[0], names
    torch.testing.assert_close(
        tp.patchify_conv(xt, wt, clip01=True).float(),
        tp.patchify_conv_reference(xt, wt, clip01=True).float(),
        **_TOL[dtype])


@pytest.mark.gpu
def test_misaligned_image_keeps_the_cuda_core_kernel(cuda):
    """The tensor-core kernel copies 16 bytes at a time; an image that
    starts 4 bytes into its storage goes to the kernel that reads value by
    value."""
    x, w = _inputs((1, 32, 32, 3), 8, 16, seed=6)
    flat = torch.zeros(x.size + 4, device=cuda)
    xt = flat[1:1 + x.size].view(x.shape).copy_(torch.from_numpy(x))
    wt = torch.from_numpy(w).to(cuda, torch.bfloat16)
    assert xt.is_contiguous() and xt.data_ptr() % 16
    tp.patchify_conv(xt, wt)
    names = _kernel_names(lambda: tp.patchify_conv(xt, wt),
                          "patchify_fwd")
    assert len(names) == 1 and "patchify_fwd_kernel" in names[0], names
    torch.testing.assert_close(
        tp.patchify_conv(xt, wt).float(),
        tp.patchify_conv_reference(xt, wt).float(), **_TOL["bfloat16"])


def _dw_gate(dw, dw32, ref, ref32, patches, g):
    """The chip's K1-dW gate: float32 sums within 1e-5 of the summed
    |products| plus 1e-6, each bf16 cast within one ulp (2**-7) more."""
    scale = (patches.float().abs().t()
             @ g.reshape(-1, g.shape[-1]).float().abs()).reshape(dw32.shape)
    bound = 1e-5 * scale + 1e-6
    assert ((dw32 - ref32).abs() <= bound).all()
    assert ((dw.float() - ref.float()).abs()
            <= bound + 2.0 ** -7 * ref.float().abs()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,patch,cout", [
    ((8, 640, 640, 3), 8, 128),    # the flagship stem
    ((1, 1280, 1280, 3), 8, 128),  # the 1280px stem, batch 1: two segments
    ((8, 640, 640, 3), 16, 384),   # the ViT patch embed: 4 x 3 tiles
    ((3, 56, 600, 3), 8, 72),      # Wo = 75: ragged steps; ragged N
    ((2, 32, 32, 4), 8, 520),      # P * C_in = 32: a ragged second k tile
])
def test_tensor_core_dw(cuda, shape, patch, cout):
    """bfloat16 weights and g where the patch divides the image take the
    tensor-core weight gradient: against the plain version and the
    emulation under the chip's gate, by kernel name, and bitwise
    repeatable."""
    xt, gt = _dw_case(cuda, shape, patch, cout, "bfloat16", True, seed=8)
    plan = tp.dw_tensor_core_plan(xt.shape, gt.shape, patch, torch.bfloat16)
    assert plan is not None

    def call():
        return tp.patchify_conv_dw(xt, gt, patch, torch.bfloat16, clip01=True)

    before = tp.patchify_conv_dw.launches
    dw, dw32 = call()
    torch.cuda.synchronize()
    assert tp.patchify_conv_dw.launches == before + 1
    names = _kernel_names(call, "patchify_dw")
    assert len(names) == 1 and "patchify_dw_mma_kernel" in names[0], names
    patches, _ = tp._patch_matrix(xt, patch, torch.bfloat16, True)
    ref, ref32 = tp.patchify_conv_dw_reference(xt, gt, patch, torch.bfloat16,
                                               clip01=True)
    _dw_gate(dw, dw32, ref, ref32, patches, gt)
    emu, emu32 = tp.patchify_dw_emulation(xt, gt, patch, torch.bfloat16,
                                          clip01=True, plan=plan)
    _dw_gate(dw, dw32, emu, emu32, patches, gt)
    again, again32 = call()
    assert torch.equal(dw32, again32) and torch.equal(dw, again)


@pytest.mark.gpu
def test_tensor_core_dw_takes_any_width(cuda):
    # P=16 at W=4096: rows the CUDA-core kernel cannot stage (its float32
    # route refuses them, test_dw_kernel_refuses_rows_that_do_not_fit);
    # the tensor-core kernel cuts them into segments of 64 positions
    xt, gt = _dw_case(cuda, (1, 16, 4096, 3), 16, 8, "bfloat16", True)
    before = tp.patchify_conv_dw.launches
    dw, dw32 = tp.patchify_conv_dw(xt, gt, 16, torch.bfloat16, clip01=True)
    torch.cuda.synchronize()
    assert tp.patchify_conv_dw.launches == before + 1
    ref, ref32 = tp.patchify_conv_dw_reference(xt, gt, 16, torch.bfloat16,
                                               clip01=True)
    patches, _ = tp._patch_matrix(xt, 16, torch.bfloat16, True)
    _dw_gate(dw, dw32, ref, ref32, patches, gt)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,patch,cout,w_dtype,g_dtype", [
    ((2, 640, 640, 3), 8, 128, "float32", "float32"),   # float32 weights
    ((2, 640, 640, 3), 8, 128, "bfloat16", "float32"),  # g not bf16
    ((2, 64, 48, 3), 4, 64, "bfloat16", "bfloat16"),    # P * C_in = 12
    ((1, 100, 84, 3), 8, 24, "bfloat16", "bfloat16"),   # SAME padding
])
def test_other_dw_inputs_keep_the_cuda_core_kernel(cuda, shape, patch, cout,
                                                   w_dtype, g_dtype):
    xt, gt = _dw_case(cuda, shape, patch, cout, g_dtype, True, seed=9)
    w_dt = _DT[w_dtype]

    def call():
        return tp.patchify_conv_dw(xt, gt, patch, w_dt, clip01=True)

    dw, dw32 = call()
    names = _kernel_names(call, "patchify_dw")
    assert len(names) == 1 and "patchify_dw_partial_kernel" in names[0], names
    ref, ref32 = tp.patchify_conv_dw_reference(xt, gt, patch, w_dt,
                                               clip01=True)
    patches, _ = tp._patch_matrix(xt, patch, w_dt, True)
    g_r = gt.to(w_dt)
    _dw_gate(dw, dw32, ref if w_dt == torch.bfloat16 else ref32, ref32,
             patches, g_r)
