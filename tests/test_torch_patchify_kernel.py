"""The hand-written CUDA kernel of the patchify stem
(boosted_detr_torch/csrc/patchify.cu) against its plain PyTorch version on
the card. It needs a CUDA card and nvcc, and skips without a card. It
imports nothing of JAX, so that it runs on a machine without it:

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
