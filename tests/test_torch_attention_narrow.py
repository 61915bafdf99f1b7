"""The fused attention (K3) up to D = 128, on the CPU, with no JAX: D = 80
run at its true width against D = 80 padded with zeros to 128, bit for
bit, in the tensor-core emulations (the bf16 forward, dq and dk/dv on
``wgmma``) and the plain versions' products; D = 32's gradient products
over rows staged 64 dims wide with zeros past dim 32, as the wgmma
forward, dq and dk/dv stage them, against D = 32 (the forward's emulation
too); and the routes (by head dim, and for the gradients at D <= 64 by
the length of the stream) ``narrow_forward_kernel`` and
``narrow_gradient_kernels`` name, read against csrc/attention.cu.
tests/test_torch_attention.py holds these
versions against JAX's Pallas kernel in interpret mode at D = 32 to 128,
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


@pytest.mark.parametrize("bh,tq,tk", [(2, 130, 70), (3, 17, 17)])
def test_head_dim_32_in_a_64_dim_slab_equals_it_at_32(bh, tq, tk):
    """The wgmma dq and dk/dv stage D = 32's rows in one 64-dim slab, TMA
    writing zeros past dim 32: the first products issue D = 32's two
    16-dim steps and the second take N = 32. Zero columns add exact zeros:
    the emulations of dq and dk/dv over the rows zero-filled to 64 dims,
    with the true 1/sqrt(32), give D = 32's bits, and the plain versions'
    float32 products over the zero-filled rows D = 32's."""
    q, k, v, g, lse, delta = _bf16_gradient_inputs(bh, tq, tk, 32, seed=1)
    slab = [torch.nn.functional.pad(t, (0, 32)) for t in (q, k, v, g)]
    scale = ta._scale(32)
    native = (ta.attention_dq_emulation(q, k, v, g, lse, delta),
              *ta.attention_dkdv_emulation(q, k, v, g, lse, delta))
    staged = (ta.attention_dq_emulation(*slab, lse, delta, scale=scale),
              *ta.attention_dkdv_emulation(*slab, lse, delta, scale=scale))
    for name, a, b in zip(("dq", "dk", "dv"), native, staged):
        assert not b[..., 32:].any(), name
        assert torch.equal(a, b[..., :32]), name
    f = [t.float() for t in (q, k, v, g)]
    fs = [t.float() for t in slab]
    assert torch.equal(f[0] @ f[1].transpose(1, 2),
                       fs[0] @ fs[1].transpose(1, 2))
    assert torch.equal(f[3] @ f[2].transpose(1, 2),
                       fs[3] @ fs[2].transpose(1, 2))
    _, p, ds = ta._rebuilt(q, k, v, g, lse, delta)
    for rows, rows_s, x in ((f[1], fs[1], ds),
                            (f[3], fs[3], p.transpose(1, 2)),
                            (f[0], fs[0], ds.transpose(1, 2))):
        assert torch.equal(x @ rows, (x @ rows_s)[..., :32])


@pytest.mark.parametrize("bh,tq,tk", [(2, 130, 70), (3, 17, 1), (2, 96, 200)])
def test_forward_head_dim_32_in_a_64_dim_slab_equals_it_at_32(bh, tq, tk):
    """The wgmma forward stages D = 32's q, k and v rows in one 64-dim
    slab, TMA writing zeros past dim 32: S = q k^T issues D = 32's two
    16-dim steps and P.V takes N = 32. Zero columns add exact zeros: the
    forward's emulation over the rows zero-filled to 64 dims, with the true
    1/sqrt(32), gives D = 32's out (zeros past dim 32) and lse bit for
    bit, and so does the plain forward."""
    q, k, v = _bf16_gradient_inputs(bh, tq, tk, 32, seed=2)[:3]
    slab = [torch.nn.functional.pad(t, (0, 32)) for t in (q, k, v)]
    scale = ta._scale(32)
    out, lse = ta.attention_fwd_emulation(q, k, v)
    out_s, lse_s = ta.attention_fwd_emulation(*slab, scale=scale)
    assert not out_s[..., 32:].any()
    assert torch.equal(out, out_s[..., :32]) and torch.equal(lse, lse_s)
    f = [t.float() for t in (q, k, v)]
    fs = [t.float() for t in slab]
    assert torch.equal(f[0] @ f[1].transpose(1, 2),
                       fs[0] @ fs[1].transpose(1, 2))
    p = torch.softmax(f[0] @ f[1].transpose(1, 2), -1)
    assert torch.equal(p @ f[2], (p @ fs[2])[..., :32])


@pytest.mark.parametrize("d,warpgroups", [(16, 1), (33, 1), (48, 1),
                                          (64, 1), (65, 2), (80, 2),
                                          (81, 2), (100, 2), (128, 2)])
def test_narrow_gradient_route_follows_the_source(d, warpgroups):
    """``narrow_forward_kernel`` and ``narrow_gradient_kernels`` name the
    kernels csrc/attention.cu launches up to D = 128: the launcher sends
    the bf16 forward at every built D to the wgmma kernel (no ``mma.sync``
    forward is left), in blocks of ``warpgroups`` warpgroups
    (``FwdNarrowPlan``: one at a padded D <= 64, two at 80 and 128); and
    bf16 dq and dk/dv to the wgmma kernels at every built D but over a
    stream of at most ``SHORT_STREAM`` rows (Tk for dq, Tq for dk/dv),
    which the ``mma.sync`` ones keep for dq at D = 32 and for dk/dv at 32
    and 64; every built head dim has its launcher, D in (64, 80] runs at
    80 with no padding and D in (80, 128] at 128; past 128 both raise."""
    src = (Path(ta.__file__).resolve().parents[1] / "csrc"
           / "attention.cu").read_text()

    def constant(name):
        return int(src.split(f"\nconstexpr int {name} = ")[1].split(";")[0])

    assert ta.narrow_forward_kernel(d) == "attn_fwd_wgmma_kernel"
    assert ("  static constexpr int WGS = D > SLAB ? NARROW_WGS : "
            "FWD_NARROW_WGS;") in src
    built = ta.padded_head_dim(d)
    assert warpgroups == (constant("NARROW_WGS") if built > constant("SLAB")
                          else constant("FWD_NARROW_WGS"))
    short, long = ta.SHORT_STREAM, ta.SHORT_STREAM + 1
    dq_short = "mma" if ta.padded_head_dim(d) == 32 else "wgmma"
    dkdv_short = "mma" if ta.padded_head_dim(d) <= 64 else "wgmma"
    for tq, tk, dq, dkdv in ((long, long, "wgmma", "wgmma"),
                             (short, long, "wgmma", dkdv_short),
                             (long, short, dq_short, "wgmma"),
                             (1, 1, dq_short, dkdv_short)):
        assert ta.narrow_gradient_kernels(d, tq, tk) == (
            f"attn_dq_{dq}_kernel", f"attn_dkdv_{dkdv}_kernel")
    for kind, kernels in (("fwd", ("wgmma",)), ("dq", ("mma", "wgmma")),
                          ("dkdv", ("mma", "wgmma"))):
        for kernel in kernels:  # a kernel of that name is defined
            assert f"\nattn_{kind}_{kernel}_kernel(" in src
    assert "\nattn_fwd_mma_kernel(" not in src
    # the widest D whose dq (32) and dk/dv (64) keep mma.sync over short
    # streams
    tile = int(src.split("constexpr int TILE = ")[1].split(";")[0])
    assert "constexpr int SHORT_STREAM = 2 * TILE;" in src
    assert ta.SHORT_STREAM == 2 * tile
    body = src.split("cudaError_t launch_fwd(")[1].split("\n}\n")[0]
    assert ("if constexpr (std::is_same_v<T, bf16>) {\n"
            "    return launch_fwd_wgmma<D>(") in body
    body = src.split("cudaError_t launch_fwd_wgmma(const void* q")[2].split(
        "\n}\n")[0]
    assert ("  using P = FwdNarrowPlan<D>;" in body
            and "<<<BH * tiles, P::THREADS, P::SMEM, stream>>>" in body)
    assert ("__launch_bounds__(FwdNarrowPlan<D>::THREADS,\n"
            "                                  FwdNarrowPlan<D>::BLOCKS)\n"
            "attn_fwd_wgmma_kernel(") in src
    for kind, stream, widest in (("dq", "Tk", "D == 32"),
                                 ("dkdv", "Tq", "D <= 64")):
        body = src.split(f"cudaError_t launch_{kind}(")[1].split("\n}\n")[0]
        branch, _ = body.split(
            "} else if constexpr (std::is_same_v<T, bf16>) {\n"
            f"    return launch_{kind}_wgmma<D>(")
        assert (f"if constexpr (std::is_same_v<T, bf16> && {widest}) {{\n"
                f"    if ({stream} > SHORT_STREAM)\n"
                f"      return launch_{kind}_wgmma<D>(") in branch
        assert f"attn_{kind}_mma_kernel<D><<<" in branch
    for built in ta.SUPPORTED_HEAD_DIMS:
        assert f"else if ((D) == {built})" in src
    assert ta.padded_head_dim(d) == next(
        n for n in ta.SUPPORTED_HEAD_DIMS if n >= d)
    with pytest.raises(ValueError):
        ta.narrow_forward_kernel(129)
    with pytest.raises(ValueError):
        ta.narrow_gradient_kernels(129, long, long)
