"""The port's patchify stem (boosted_detr_torch/ops/patchify.py) against the
JAX package's ``patchify_conv`` (ops/pallas_patchify.py), which runs its
Pallas kernel through the interpreter on the CPU. On a CPU tensor the
port's wrapper takes its plain PyTorch version, so these tests hold that
version, the arithmetic the CUDA kernel repeats, against the TPU kernel.
The kernel itself is held against the plain version on the card by
test_torch_patchify_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boosted_detr_torch.ops import patchify as tp
from boosted_detr_tpu.ops import pallas_patchify as jp

torch.set_num_threads(2)

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, patch, cout, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, shape).astype(np.float32)
    w = (rng.standard_normal((patch, patch, shape[-1], cout)) * 0.1).astype(
        np.float32)
    return x, w


def _both(x, w, dtype, clip01):
    tdt, jdt = _DT[dtype]
    ours = tp.patchify_conv(torch.from_numpy(x),
                            torch.from_numpy(w).to(tdt), clip01=clip01)
    ref = jp.patchify_conv(jnp.asarray(x), jnp.asarray(w).astype(jdt),
                           clip01=clip01)
    return (ours.float().numpy(),
            np.asarray(jnp.asarray(ref, jnp.float32)))


# f32: both sides round nothing, so only the order of the float32 sums over
# K <= 192 terms of size ~0.1 differs: 1e-5 covers it. bf16: the inputs are
# rounded identically on both sides and both accumulate in float32, so the
# outputs differ by at most one rounding of the bf16 result (2**-8
# relative); atol 2e-2 covers one ulp of outputs up to ~4.
_TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
        "bfloat16": dict(atol=2e-2, rtol=8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip01", [True, False])
@pytest.mark.parametrize("shape,patch,cout", [
    ((2, 32, 32, 3), 8, 16),   # the patchify8 stem, scaled down
    ((1, 16, 24, 3), 4, 8),    # the patchify stem, non-square image
])
def test_matches_jax_kernel(shape, patch, cout, dtype, clip01):
    x, w = _inputs(shape, patch, cout)
    ours, ref = _both(x, w, dtype, clip01)
    assert ours.shape == ref.shape == (
        shape[0], shape[1] // patch, shape[2] // patch, cout)
    np.testing.assert_allclose(ours, ref, **_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_non_divisible_geometry_is_same_padded_conv(dtype):
    # H=20, W=27 with P=8: the JAX package leaves its kernel for an
    # ordinary SAME conv (``supported`` is False); the port pads the same
    # way, (2, 2) rows and (2, 3) columns of zeros.
    x, w = _inputs((1, 20, 27, 3), 8, 8, seed=1)
    assert not jp.supported(x.shape, 8)
    ours, ref = _both(x, w, dtype, clip01=True)
    assert ours.shape == ref.shape == (1, 3, 4, 8)
    np.testing.assert_allclose(ours, ref, **_TOL[dtype])


def test_same_padding_is_asymmetric():
    # XLA's SAME: total // 2 before, the rest after
    assert tp.same_padding(8, 3, 2) == (0, 1)
    assert tp.same_padding(9, 3, 2) == (1, 1)
    assert tp.same_padding(20, 8, 8) == (2, 2)
    assert tp.same_padding(27, 8, 8) == (2, 3)
    assert tp.same_padding(64, 8, 8) == (0, 0)


def test_wrapper_checks_and_counts_only_launches():
    x, w = _inputs((1, 16, 16, 3), 8, 4)
    before = tp.patchify_conv.launches
    tp.patchify_conv(torch.from_numpy(x), torch.from_numpy(w))
    assert tp.patchify_conv.launches == before  # the plain version is no launch
    with pytest.raises(TypeError):
        tp.patchify_conv(torch.from_numpy(x).double(), torch.from_numpy(w))
    with pytest.raises(ValueError):
        tp.patchify_conv(torch.from_numpy(x), torch.from_numpy(w[:4]))
