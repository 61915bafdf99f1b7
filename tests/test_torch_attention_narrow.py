"""The fused attention (K3) at ViT head dims (D = 80 and 128), on the CPU,
with no JAX: D = 80 run at its true width against D = 80 padded with
zeros to 128, bit for bit, in the tensor-core emulations (the bf16
forward, dq and dk/dv on ``wgmma``) and the plain versions' products;
and the routes ``narrow_forward_kernel`` and ``narrow_gradient_kernels``
name, read against csrc/attention.cu. tests/test_torch_attention.py holds these
versions against JAX's Pallas kernel in interpret mode at D = 80 and 128,
and tests/test_torch_attention_kernel.py the kernels against them on the
card."""

from pathlib import Path

import numpy as np
import pytest
import torch

from boosted_detr_torch.ops import attention as ta

torch.set_num_threads(2)

def _bf16_gradient_inputs(bh, tq, tk, d, seed=0):
    """bf16 (q, k, v, g) from a seeded normal, with the plain forward's lse
    and delta = rowsum(g * out) less a random cotangent of the lse."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(
        np.float32)).bfloat16() for t in (tq, tk, tk, tq))
    g_lse = torch.from_numpy(rng.standard_normal((bh, tq)).astype(np.float32))
    out, lse = ta.attention_fwd_reference(q, k, v)
    return q, k, v, g, lse, (g.float() * out.float()).sum(-1) - g_lse


@pytest.mark.parametrize("bh,tq,tk", [(2, 130, 70), (3, 17, 17)])
def test_head_dim_80_at_its_width_equals_it_padded_to_128(bh, tq, tk):
    """Zero columns add exact zeros to every sum: the emulations of the
    forward, dq and dk/dv at D = 80 give, bit for bit, what they give on
    the same tensors padded with zeros to 128 (the TPU's width and the
    port's before it ran D = 80 as built) with the true 1/sqrt(80), sliced
    back; so do the plain gradients' float32 products."""
    q, k, v, g, lse, delta = _bf16_gradient_inputs(bh, tq, tk, 80)
    pad = [torch.nn.functional.pad(t, (0, 48)) for t in (q, k, v, g)]
    scale = ta._scale(80)
    native = (*ta.attention_fwd_emulation(q, k, v),
              ta.attention_dq_emulation(q, k, v, g, lse, delta),
              *ta.attention_dkdv_emulation(q, k, v, g, lse, delta))
    padded = (*ta.attention_fwd_emulation(*pad[:3], scale=scale),
              ta.attention_dq_emulation(*pad, lse, delta, scale=scale),
              *ta.attention_dkdv_emulation(*pad, lse, delta, scale=scale))
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), native, padded):
        if b.dim() == 3:
            assert not b[..., 80:].any(), name
            b = b[..., :80]
        assert torch.equal(a, b), name
    # the plain versions' float32 products: q.k and dO.v over D, and ds.k,
    # p^T dO and ds^T q over the rows, the same with the zero columns
    f = [t.float() for t in (q, k, v, g)]
    fp = [t.float() for t in pad]
    assert torch.equal(f[0] @ f[1].transpose(1, 2),
                       fp[0] @ fp[1].transpose(1, 2))
    assert torch.equal(f[3] @ f[2].transpose(1, 2),
                       fp[3] @ fp[2].transpose(1, 2))
    _, p, ds = ta._rebuilt(q, k, v, g, lse, delta)
    for rows, rows_p, x in ((f[1], fp[1], ds),
                            (f[3], fp[3], p.transpose(1, 2)),
                            (f[0], fp[0], ds.transpose(1, 2))):
        assert torch.equal(x @ rows, (x @ rows_p)[..., :80])


@pytest.mark.parametrize("d,route", [(16, "mma"), (33, "mma"), (48, "mma"),
                                     (64, "mma"), (65, "wgmma"),
                                     (80, "wgmma"), (81, "wgmma"),
                                     (100, "wgmma"), (128, "wgmma")])
def test_narrow_gradient_route_follows_the_source(d, route):
    """``narrow_forward_kernel`` and ``narrow_gradient_kernels`` name the
    kernels csrc/attention.cu launches up to D = 128: the launchers send
    bf16 past D = 64 to the wgmma kernels (the forward's too: the
    ``mma.sync`` forward keeps D = 32 and 64 alone), every built head dim
    has its launcher, D in (64, 80] runs at 80 with no padding and D in
    (80, 128] at 128; past 128 both raise."""
    src = (Path(ta.__file__).resolve().parents[1] / "csrc"
           / "attention.cu").read_text()
    names = (ta.narrow_forward_kernel(d), *ta.narrow_gradient_kernels(d))
    assert names == (f"attn_fwd_{route}_kernel", f"attn_dq_{route}_kernel",
                     f"attn_dkdv_{route}_kernel")
    for name in names:
        assert f"\n{name}(" in src  # a kernel of that name is defined
    for kind in ("fwd", "dq", "dkdv"):
        body = src.split(f"cudaError_t launch_{kind}(")[1].split("\n}\n")[0]
        assert "std::is_same_v<T, bf16> && D > 64" in body
        assert f"return launch_{kind}_wgmma<D>(" in body
    assert 'static_assert(D <= 64, "D = 80 and 128 take attn_fwd_wgmma' in src
    for built in ta.SUPPORTED_HEAD_DIMS:
        assert f"else if ((D) == {built})" in src
    assert ta.padded_head_dim(d) == next(
        n for n in ta.SUPPORTED_HEAD_DIMS if n >= d)
    for name in (ta.narrow_forward_kernel, ta.narrow_gradient_kernels):
        with pytest.raises(ValueError):
            name(129)
