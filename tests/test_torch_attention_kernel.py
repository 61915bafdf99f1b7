"""The hand-written CUDA kernels of the fused attention
(boosted_detr_torch/csrc/attention.cu: K3's forward with the lse, dq and
dk/dv) against their plain PyTorch versions on the card, the autograd
``FusedAttentionFn`` on the card against its CPU route, and the refusal of
a head dim the kernels are not built for. It needs a CUDA card and nvcc,
and skips without a card. It imports nothing of JAX, so that it runs on a
machine without it:

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
def test_function_gradients_on_the_card_match_the_cpu_route(cuda, dtype):
    q, k, v, g, g_lse = _inputs(cuda, 2, 130, 200, 64, dtype, seed=1)
    grads = {}
    for dev in ("cpu", "cuda"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        out, lse = ta.fused_attention_with_lse(*leaves)
        torch.autograd.backward([out, lse], [g.to(dev), g_lse.to(dev)])
        grads[dev] = [out, lse] + [t.grad for t in leaves]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got.abs().sum() > 0
        _assert_close(got.cpu(), want, dtype, grad=True)


@pytest.mark.gpu
def test_unsupported_head_dim_raises(cuda):
    q = torch.zeros((2, 8, 48), device=cuda)
    before = ta.attention_fwd.launches
    with pytest.raises(ValueError, match="D=48"):
        ta.fused_attention(q, q, q)
    assert ta.attention_fwd.launches == before
    # the CPU route is the plain version, for any head dim
    assert ta.fused_attention(q.cpu(), q.cpu(), q.cpu()).shape == (2, 8, 48)
