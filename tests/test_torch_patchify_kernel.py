"""The hand-written CUDA kernels of the patchify stem
(boosted_detr_torch/csrc/patchify.cu: the forward and the weight gradient)
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
def test_kernel_refuses_rows_that_do_not_fit(cuda):
    # 16 float32 rows of 4096 x 3 values are 786 KB, over the 227 KB a
    # block may use, even before the kernel slice
    x = torch.zeros((1, 16, 4096, 3), device=cuda)
    w = torch.zeros((16, 16, 3, 8), device=cuda)
    before = tp.patchify_conv.launches
    with pytest.raises(ValueError, match="shared memory"):
        tp.patchify_conv(x, w)
    assert tp.patchify_conv.launches == before


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
def test_dw_kernel_refuses_rows_that_do_not_fit(cuda):
    # P=16 at W=4096: 3 staged rows of 12,288 values and a g row of 256 x
    # 128 need 278 KB, over the 227 KB a block may use
    x = torch.zeros((1, 16, 4096, 3), device=cuda)
    g = torch.zeros((1, 1, 256, 8), device=cuda)
    before = tp.patchify_conv_dw.launches
    with pytest.raises(ValueError, match="shared memory"):
        tp.patchify_conv_dw(x, g, 16, torch.float32)
    assert tp.patchify_conv_dw.launches == before
