"""The port's fused attention (boosted_detr_torch/ops/attention.py, the K3
kernels' CPU route) and the models' fused route against the JAX package,
on the CPU (the ViT backbone: tests/test_torch_vit.py).
The JAX side reaches its Pallas attention
kernel in interpret mode: ``fused_attention`` is called with
``interpret=True``, and the JAX MHA, which imports
``boosted_detr_tpu.ops.pallas_attention.fused_attention`` at call time
(layers.py:106), gets it through a monkeypatch of that attribute, as
tests/test_pallas_attention.py does. The arithmetic of the tensor-core
kernels (bf16 inputs on the card: the forward, dq and dk/dv) is held here
through its plain PyTorch emulation, against the card's gates and against the Pallas
kernels. Inputs and weights are made with numpy from fixed seeds and
carried across by ``load_flax_variables``."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import backbone as tb
from boosted_detr_torch.models import layers as tl
from boosted_detr_torch.ops import attention as ta
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models import layers as jl
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.ops import pallas_attention as jpa
from boosted_detr_tpu.train import steps as jsteps

torch.set_num_threads(2)

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# The K3 functions on identical inputs. float32: the same float32 formulas,
# summed in other orders (the TPU kernel's 512-key online softmax against
# one full softmax): measured under 1e-6 on values up to ~7 (the lse);
# 2e-6 + 1e-5 relative leaves room. bfloat16: both read the same bf16
# inputs and compute in float32, so the results differ by those float32
# sums plus one rounding of the result, a bf16 ulp (2**-7 relative).
K3_TOL = {"float32": dict(atol=2e-6, rtol=1e-5),
          "bfloat16": dict(atol=1e-5, rtol=2.0 ** -7)}
# A bf16 gradient also inherits, through delta = rowsum(dO * O), the
# one-ulp differences of the bf16 output: measured up to 1.1e-5 on
# gradients up to 0.7.
K3_GRAD_TOL = dict(K3_TOL, bfloat16=dict(atol=5e-5, rtol=2.0 ** -7))
# Models in float32: the sides differ by float32 sum order through the
# blocks; measured under 2e-6 on outputs of unit scale, held to 1e-5.
F32 = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX MHA's fused route through the Pallas kernel's interpreter."""
    kernel = jpa.fused_attention
    monkeypatch.setattr(jpa, "fused_attention",
                        lambda *a, **kw: kernel(*a, interpret=True))


def _np(t):
    return t.detach().float().numpy()


def _close(ours, ref, tol, what=""):
    np.testing.assert_allclose(_np(ours), np.asarray(ref, np.float32),
                               err_msg=what, **tol)


def _perturbed(variables, rng, noise=0.1, zero_bias=False):
    """Flax variables -> nested numpy dicts, every leaf shifted by seeded
    noise; with ``zero_bias`` the ``bias`` leaves are zeros instead."""
    def draw(path, a):
        a = np.asarray(a, np.float32)
        if zero_bias and path[-1].key == "bias":
            return np.zeros_like(a)
        return a + (rng.standard_normal(a.shape) * noise).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------- K3 itself

def _k3_inputs(bh, tq, tk, d):
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((bh, t, d)).astype(np.float32)
               for t in (tq, tk, tk))
    g = rng.standard_normal((bh, tq, d)).astype(np.float32)
    g_lse = rng.standard_normal((bh, tq)).astype(np.float32)
    return q, k, v, g, g_lse


@functools.cache
def _pallas_k3(bh, tq, tk, d, dtype):
    """(out, lse, dq, dk, dv) of fused_attention_with_lse run through the
    interpreter on ``_k3_inputs``, with a cotangent of both outputs."""
    jdt = _DT[dtype][1]
    q, k, v, g, g_lse = _k3_inputs(bh, tq, tk, d)
    jin = [jnp.asarray(a, jdt) for a in (q, k, v)]
    (j_out, j_lse), vjp = jax.vjp(
        lambda *a: jpa.fused_attention_with_lse(*a, interpret=True), *jin)
    # every JAX result is ready before the port runs: the port's output once
    # came out 1e-4 off while JAX's asynchronous work was still in flight
    j_grads = jax.block_until_ready(
        vjp((jnp.asarray(g, jdt), jnp.asarray(g_lse))))
    return tuple(np.asarray(a, np.float32) for a in (j_out, j_lse, *j_grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,tq,tk,d", [(2, 130, 200, 32),  # one block each
                                        (2, 300, 520, 64),  # straddles both
                                        (2, 17, 1000, 32),  # tiny q
                                        # ViT-Huge's D = 80 and D = 128,
                                        # ragged, both at their true width
                                        (2, 72, 130, 80),
                                        (2, 72, 130, 128),
                                        (2, 130, 70, 80),
                                        (3, 17, 17, 128)])
def test_k3_matches_the_pallas_kernel(bh, tq, tk, d, dtype):
    """out, lse, and the gradients of a random cotangent of both, the lse's
    included (it folds into delta), against fused_attention_with_lse run
    through the interpreter."""
    tdt = _DT[dtype][0]
    q, k, v, g, g_lse = _k3_inputs(bh, tq, tk, d)
    j_out, j_lse, *j_grads = _pallas_k3(bh, tq, tk, d, dtype)

    tin = [torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out, lse = ta.fused_attention_with_lse(*tin)
    assert out.dtype == tdt and lse.dtype == torch.float32
    assert lse.shape == (bh, tq)
    torch.autograd.backward([out, lse], [torch.tensor(g).to(tdt),
                                         torch.tensor(g_lse)])
    tol = K3_TOL[dtype]
    _close(out, j_out, tol, "out")
    _close(lse, j_lse, K3_TOL["float32"], "lse")
    for name, t, j in zip("qkv", tin, j_grads):
        assert t.grad.dtype == tdt
        _close(t.grad, j, K3_GRAD_TOL[dtype], f"d{name}")


# ------------- the arithmetic of the tensor-core gradient kernels (bf16)

# The gates that chip_smoke.py holds the gradient kernels to on the card,
# against their plain versions: 1e-4 for the float32 sums, then one rounding
# of the bf16 result (2**-7 relative).
CARD_GRAD_GATE = dict(atol=1e-4, rtol=2.0 ** -7)
_EMULATED = [(2, 130, 200, 32), (2, 300, 520, 64), (2, 17, 1000, 32),
             (2, 1, 200, 32),    # one query row
             (2, 130, 1, 64),    # one key
             (2, 96, 1600, 32)]  # the 1280px cross-attention


def _bf16_gradient_inputs(bh, tq, tk, d):
    """bf16 (q, k, v, g, lse, delta) as the Function's backward hands them
    to the gradient wrappers, from ``_k3_inputs``."""
    q, k, v, g, g_lse = _k3_inputs(bh, tq, tk, d)
    q, k, v, g = (torch.tensor(a).bfloat16() for a in (q, k, v, g))
    out, lse = ta.attention_fwd_reference(q, k, v)
    delta = (g.float() * out.float()).sum(-1) - torch.tensor(g_lse)
    return q, k, v, g, lse, delta


def _outside(got, want, atol, rtol):
    """How many values of ``got`` lie outside atol + rtol |want|."""
    got, want = got.float(), want.float()
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


@pytest.mark.parametrize("bh,tq,tk,d", _EMULATED)
def test_tensor_core_arithmetic_passes_the_card_gates(bh, tq, tk, d):
    """64-row tiles, the scale on the float32 logit, p and ds as bf16
    hi + lo, dq and dk scaled at the end: inside the card's gates against
    the plain versions."""
    args = _bf16_gradient_inputs(bh, tq, tk, d)
    dq = ta.attention_dq_emulation(*args)
    dk, dv = ta.attention_dkdv_emulation(*args)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    for name, got, want in (("dq", dq, ta.attention_dq_reference(*args)),
                            ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        assert _outside(got, want, **CARD_GRAD_GATE) == 0, name


@pytest.mark.parametrize("bh,tq,tk,d", _EMULATED)
def test_tensor_core_arithmetic_matches_the_pallas_kernel(bh, tq, tk, d):
    """The same arithmetic against the gradients of JAX's Pallas kernels in
    interpret mode, at the tolerance of the plain versions."""
    args = _bf16_gradient_inputs(bh, tq, tk, d)
    j_dq, j_dk, j_dv = _pallas_k3(bh, tq, tk, d, "bfloat16")[2:]
    dk, dv = ta.attention_dkdv_emulation(*args)
    tol = K3_GRAD_TOL["bfloat16"]
    _close(ta.attention_dq_emulation(*args), j_dq, tol, "dq")
    _close(dk, j_dk, tol, "dk")
    _close(dv, j_dv, tol, "dv")


def test_one_bf16_rounding_of_p_and_ds_fails_the_card_gates():
    """Why p and ds are split: rounded to one bf16 value each before the
    second products, the decoder self-attention's gradients (96 queries, 96
    keys) leave the gates that the split passes."""
    args = _bf16_gradient_inputs(8, 96, 96, 32)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    want = (ta.attention_dq_reference(*args), want_dk, want_dv)

    def outside(split):
        got = (ta.attention_dq_emulation(*args, split=split),
               *ta.attention_dkdv_emulation(*args, split=split))
        return [_outside(a, b, **CARD_GRAD_GATE) for a, b in zip(got, want)]

    assert outside(split=True) == [0, 0, 0]
    assert all(n > 0 for n in outside(split=False)), outside(split=False)


# The gates that chip_smoke.py holds the forward to on the card, against
# its plain version: one rounding of the bf16 result over 1e-5, and the
# float32 lse.
CARD_OUT_GATE = dict(atol=1e-5, rtol=2.0 ** -7)
CARD_LSE_GATE = dict(atol=1e-5, rtol=1e-5)


def _bf16_forward_inputs(bh, tq, tk, d):
    return tuple(torch.tensor(a).bfloat16()
                 for a in _k3_inputs(bh, tq, tk, d)[:3])


@pytest.mark.parametrize("bh,tq,tk,d", _EMULATED)
def test_tensor_core_forward_arithmetic_passes_the_card_gates(bh, tq, tk, d):
    """The online softmax over 64-key tiles with the scale inside the
    exponent, the denominator summed from the float32 p and p as bf16
    hi + lo in P.V: inside the card's gates against the plain version."""
    q, k, v = _bf16_forward_inputs(bh, tq, tk, d)
    out, lse = ta.attention_fwd_emulation(q, k, v)
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    assert lse.dtype == torch.float32 and lse.shape == (bh, tq)
    assert _outside(out, want, **CARD_OUT_GATE) == 0
    assert _outside(lse, want_lse, **CARD_LSE_GATE) == 0


@pytest.mark.parametrize("bh,tq,tk,d", _EMULATED)
def test_tensor_core_forward_arithmetic_matches_the_pallas_kernel(bh, tq, tk,
                                                                  d):
    """The same arithmetic against JAX's Pallas forward in interpret mode,
    at the tolerance of the plain version."""
    q, k, v = _bf16_forward_inputs(bh, tq, tk, d)
    out, lse = ta.attention_fwd_emulation(q, k, v)
    j_out, j_lse = _pallas_k3(bh, tq, tk, d, "bfloat16")[:2]
    _close(out, j_out, K3_TOL["bfloat16"], "out")
    _close(lse, j_lse, K3_TOL["float32"], "lse")


def test_one_bf16_rounding_of_p_fails_the_forward_gate():
    """Why p is split in the forward too: rounded to one bf16 value before
    P.V, the output leaves the one-ulp gate where the values of v cancel
    (about a tenth of the values at the 1280px cross-attention's shape),
    which the split passes; the lse never sees p's rounding."""
    q, k, v = _bf16_forward_inputs(4, 96, 1600, 32)
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    outside = {}
    for split in (True, False):
        out, lse = ta.attention_fwd_emulation(q, k, v, split=split)
        assert _outside(lse, want_lse, **CARD_LSE_GATE) == 0
        outside[split] = _outside(out, want, **CARD_OUT_GATE)
    assert outside[True] == 0
    assert outside[False] > want.numel() // 50, outside


@pytest.mark.parametrize("bh,tq,tk,d,built", [
    (2, 130, 200, 48, 64), (2, 96, 400, 48, 64),
    # ViT-Huge's widths (1280 over 16 heads) and D = 128 (vit_w512_h4),
    # both as built (the bf16 forward, dq and dk/dv on the wgmma kernels),
    # ragged
    (2, 72, 130, 80, 80), (2, 72, 130, 128, 128), (2, 130, 70, 80, 80),
    (3, 17, 17, 128, 128)])
def test_padded_head_dim_arithmetic_matches_the_pallas_kernel(bh, tq, tk, d,
                                                              built):
    """D = 48 (``encoder_dim=384, num_encoder_heads=8``), which the
    kernels take padded with zeros to 64 and the true 1/sqrt(D), and
    D = 80 and 128 as built: the tensor-core arithmetic on the padded
    tensors, sliced back, inside the card's gates against the plain
    versions at D and against JAX's Pallas kernels in interpret mode (which
    pad D to 128 themselves)."""
    scale = 1.0 / d ** 0.5
    q, k, v, g, lse, delta = _bf16_gradient_inputs(bh, tq, tk, d)
    qp, kp, vp, gp = ta._padded(q, k, v, g)
    assert qp.shape == (bh, tq, built) and not qp[..., d:].any()
    out, p_lse = ta.attention_fwd_emulation(qp, kp, vp, scale=scale)
    padded = (qp, kp, vp, gp, lse, delta)
    dq = ta.attention_dq_emulation(*padded, scale=scale)
    dk, dv = ta.attention_dkdv_emulation(*padded, scale=scale)
    for t in (out, dq, dk, dv):
        assert not t[..., d:].any()  # the padded columns come out zero
    out, dq, dk, dv = (t[..., :d] for t in (out, dq, dk, dv))

    want, want_lse = ta.attention_fwd_reference(q, k, v)
    args = (q, k, v, g, lse, delta)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    assert _outside(out, want, **CARD_OUT_GATE) == 0
    assert _outside(p_lse, want_lse, **CARD_LSE_GATE) == 0
    for name, got, ref in (("dq", dq, ta.attention_dq_reference(*args)),
                           ("dk", dk, want_dk), ("dv", dv, want_dv)):
        assert _outside(got, ref, **CARD_GRAD_GATE) == 0, name

    j_out, j_lse, j_dq, j_dk, j_dv = _pallas_k3(bh, tq, tk, d, "bfloat16")
    _close(out, j_out, K3_TOL["bfloat16"], "out")
    _close(p_lse, j_lse, K3_TOL["float32"], "lse")
    tol = K3_GRAD_TOL["bfloat16"]
    _close(dq, j_dq, tol, "dq")
    _close(dk, j_dk, tol, "dk")
    _close(dv, j_dv, tol, "dv")


def test_k3_without_lse_matches_fused_attention():
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((3, t, 32)).astype(np.float32)
               for t in (40, 70, 70))
    g = rng.standard_normal((3, 40, 32)).astype(np.float32)
    j_out, vjp = jax.vjp(lambda *a: jpa.fused_attention(*a, interpret=True),
                         *map(jnp.asarray, (q, k, v)))
    j_grads = jax.block_until_ready(vjp(jnp.asarray(g)))
    tin = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    out = ta.fused_attention(*tin)
    out.backward(torch.tensor(g))
    _close(out, j_out, K3_TOL["float32"])
    for t, j in zip(tin, j_grads):
        _close(t.grad, j, K3_TOL["float32"])


def test_cpu_route_runs_the_plain_versions_and_launches_nothing():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, t, 16)).astype(
        np.float32)).requires_grad_() for t in (5, 9, 9))
    before = (ta.attention_fwd.launches, ta.attention_dq.launches,
              ta.attention_dkdv.launches)
    out, lse = ta.fused_attention_with_lse(q, k, v)
    out.sum().backward()
    assert (ta.attention_fwd.launches, ta.attention_dq.launches,
            ta.attention_dkdv.launches) == before
    want, want_lse = ta.attention_fwd_reference(q, k, v)
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=0, rtol=0)
    with pytest.raises(TypeError, match="one dtype"):
        ta.fused_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="shapes"):
        ta.fused_attention(q, k[:, :4], v)


# ------------------------------------------------------------- the modules

@pytest.mark.parametrize("qk_norm", [False, True])
def test_mha_fused_route_matches_jax(interpret, qk_norm):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 12, 64)).astype(np.float32)
    kv = rng.standard_normal((2, 20, 64)).astype(np.float32)
    jmod = jl.MultiheadAttention(2, use_pallas=True, qk_norm=qk_norm)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), q, kv, kv), rng)
    ref = jax.block_until_ready(jmod.apply(_jax(params), q, kv, kv))

    ours = tl.MultiheadAttention(64, 2, torch.float32, use_pallas=True,
                                 qk_norm=qk_norm)
    bt.load_flax_variables(ours, params)  # q_norm/scale, k_norm/scale
    assert (ours.q_norm is not None) == qk_norm
    out = ours(*(torch.from_numpy(a) for a in (q, kv, kv)))
    _close(out, ref, F32)


_FLAG = dict(image_size=(64, 64), backbone="resnet", backbone_width=0.01,
             stem="patchify8", use_pallas_stem=True, num_encoder_blocks=2,
             num_decoder_blocks=2, num_encoder_heads=2, num_decoder_heads=2,
             encoder_dim=64, decoder_dim=64, num_object_preds=8,
             num_categories=7, num_attributes=8, compute_dtype="bfloat16",
             use_pallas_attention=True)


def test_use_pallas_attention_is_honoured_in_bf16(interpret):
    """A bf16 DETR built with ``use_pallas_attention=True`` must run JAX's
    fused attention, not the plain MHA: the two differ beyond rounding
    under bf16 (the plain route casts the probabilities to bf16 before
    P.V). The transformer of the port's DETR (encoder, both decoder blocks)
    runs on fixed features against the JAX blocks with ``use_pallas=True``.
    The Dense biases are zero, so that XLA's and torch's bf16 Dense layers
    round alike (XLA rounds the product and then the bias add, torch
    once): the port's fused route then lies 5.9e-5 from JAX's in norm
    (measured), the plain route 9.5e-3 away. A port that ignored the flag
    (the tree before the fused route was ported) fails the 1e-3 bound at
    9.5e-3."""
    rng = np.random.default_rng(4)
    image = np.zeros((2, 64, 64, 3), np.float32)
    jvars = jax.jit(JaxDETR(jconfig.ModelConfig(**dict(
        _FLAG, use_pallas_attention=False))).init)(jax.random.PRNGKey(0),
                                                   image)
    variables = _perturbed(jvars, rng, zero_bias=True)
    model = bt.DETR(bt.ModelConfig(**_FLAG), device="cpu").eval()
    bt.load_flax_variables(model, variables)
    params = variables["params"]
    feats = rng.standard_normal((2, 2, 2, 64)).astype(np.float32)

    def jax_transformer(use_pallas):  # eager: XLA fusion would round less
        enc = jl.ImageEncoder(2, 2, dtype=jnp.bfloat16, use_pallas=use_pallas)
        tokens, pos = enc.apply({"params": _jax(params["encoder"])},
                                jnp.asarray(feats, jnp.bfloat16))
        prep = jl.DecoderPrep(8, 64, jnp.bfloat16)
        value, dec, key, _ = prep.apply(
            {"params": _jax(params["decoder_prep"])}, tokens, pos)
        for i in range(2):
            block = jl.DecoderBlock(2, self_attention=i > 0,
                                    dtype=jnp.bfloat16, use_pallas=use_pallas)
            dec = block.apply(
                {"params": _jax(params[f"decoder_block_{i}"])}, value, dec,
                key)
        return dec

    with torch.no_grad():
        tokens, pos = model.encoder(torch.from_numpy(feats).bfloat16())
        value, dec, key, _ = model.decoder_prep(tokens, pos)
        for i in range(2):
            dec = getattr(model, f"decoder_block_{i}")(value, dec, key)
    fused, plain = (np.asarray(jax_transformer(flag), np.float32)
                    for flag in (True, False))
    rel = np.linalg.norm(_np(dec) - fused) / np.linalg.norm(fused)
    assert rel < 1e-3, f"the port is {rel:.2e} off JAX's fused route"
    # the bound tells the routes apart: JAX's own plain route is beyond it
    assert np.linalg.norm(plain - fused) / np.linalg.norm(fused) > 2e-3


# ---------------------------------------------- a small DETR, fused route

SMALL = dict(image_size=(64, 64), backbone="resnet", backbone_width=0.25,
             stem="patchify8", use_pallas_stem=True, norm="batchnorm",
             num_encoder_blocks=2, num_decoder_blocks=2, encoder_dim=64,
             decoder_dim=64, num_object_preds=16, num_categories=12,
             num_attributes=20, max_objects=8, compute_dtype="float32",
             dropout_rate=0.0, use_pallas_attention=True)
B = 4


def _batch(rng):
    return {"image": rng.uniform(0, 1, (B, 64, 64, 3)).astype(np.float32),
            "category_ids": rng.integers(2, 12, (B, 8)).astype(np.int32),
            "attribute_ids": rng.integers(0, 20, (B, 8, 4)).astype(np.int32),
            "bbox": rng.uniform(0.05, 0.45, (B, 8, 4)).astype(np.float32),
            "num_objects": rng.integers(1, 9, (B,)).astype(np.int32)}


def _calibrated(variables, image, cfg):
    """Running statistics that normalise ``image`` without amplifying: the
    batch means of one train-mode forward of the port (momentum 0) and the
    batch variances plus 1. Random statistics would saturate the neck's
    tanh through 13 blocks and leave the backbone without gradient."""
    model = bt.DETR(cfg, device="cpu").train()
    bt.load_flax_variables(model, variables)
    for m in model.modules():
        if isinstance(m, tb.BatchNorm):
            m.momentum = 0.0
    with torch.no_grad():
        model(torch.from_numpy(image))
    stats = {k: v + 1.0 if k.endswith("running_var") else v
             for k, v in model.state_dict().items() if "running" in k}
    return dict(variables,
                batch_stats=bt.to_flax_layout(model, stats)["batch_stats"])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def _assert_trees_close(ours, ref, rel, floor, what):
    """Per leaf: ||ours - ref|| <= rel ||ref leaf|| + floor ||ref tree||."""
    ours, ref = dict(_leaves(ours)), dict(_leaves(ref))
    assert set(ours) == set(ref), set(ours) ^ set(ref)
    total = np.sqrt(sum(np.sum(np.square(r)) for r in ref.values()))
    for name, r in ref.items():
        err = np.linalg.norm(ours[name] - r)
        bound = rel * np.linalg.norm(r) + floor * total
        assert err <= bound, f"{what} {name}: {err:.3e} over {bound:.3e}"


def test_small_detr_fused_route_forward_and_train_step_match_jax(interpret):
    """The float32 DETR with ``use_pallas_attention=True``: the eval forward
    (5 fused attentions: 2 encoder, 2 cross, 1 decoder self), then one
    flagship-recipe train step (SGD, Nesterov, per-tensor clipnorm 0.1)
    with ``freeze_bn_stats`` from calibrated statistics: the losses, every
    raw gradient leaf and the new parameters. The JAX backward runs the
    Pallas dq and dk/dv kernels, the port's the plain versions of its
    kernels, both rebuilding p from the saved lse."""
    rng = np.random.default_rng(5)
    batch = _batch(rng)
    jcfg = jconfig.ModelConfig(**SMALL, matcher="hungarian")
    pcfg = bt.ModelConfig(**SMALL, matcher="pallas")
    jmodel = JaxDETR(jcfg)
    init = jax.jit(JaxDETR(dataclasses.replace(
        jcfg, use_pallas_stem=False, use_pallas_attention=False)).init)
    variables = _perturbed(init(jax.random.PRNGKey(0), batch["image"]), rng)
    variables = _calibrated(variables, batch["image"], pcfg)
    jvars = _jax(variables)

    model = bt.DETR(pcfg, device="cpu").eval()
    bt.load_flax_variables(model, variables)
    ref = jax.block_until_ready(jax.jit(
        lambda v, x: jmodel.apply(v, x, train=False))(jvars, batch["image"]))
    with torch.no_grad():
        out = model(torch.from_numpy(batch["image"]))
    for key in ("category", "attribute", "boxes"):
        _close(out[key], ref[key], F32, key)

    capture = optax.GradientTransformation(  # keeps the raw gradients
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    jt = jconfig.TrainConfig(batch_size=B, freeze_bn_stats=True)
    tx = optax.chain(capture, jsteps.make_optimizer(jt, d_model=64))
    state = jsteps.TrainState.create(jvars["params"], jvars["batch_stats"],
                                     tx)
    new, jaux = jax.block_until_ready(jax.jit(
        jsteps.make_train_step(jmodel, jcfg, jt))(state, _jax(batch),
                                                  jax.random.PRNGKey(1)))

    raw = {}
    fwd = ta.attention_fwd

    def counted(*a):
        counted.calls += 1
        return fwd(*a)

    counted.calls = 0
    tcfg = bt.TrainConfig(batch_size=B, freeze_bn_stats=True)
    tstate = bt.TrainState.create(
        model, bt.make_optimizer(tcfg, model.parameters(), d_model=64))
    clip = tsteps.clip_by_per_variable_norm

    def keep_raw(grads, max_norm):
        raw.update({n: p.grad.clone() for n, p in model.named_parameters()})
        clip(grads, max_norm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps, "clip_by_per_variable_norm", keep_raw)
        mp.setattr(ta, "attention_fwd", counted)
        _, aux = bt.make_train_step(model, pcfg, tcfg)(
            tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert counted.calls == 5
    for k in jaux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the frozen regime of tests/test_torch_train.py: sum order only
    grads = bt.to_flax_layout(model, raw)["params"]
    _assert_trees_close(grads, jax.tree_util.tree_map(
        np.asarray, new.opt_state[0]), 1e-4, 1e-6, "grad")
    params = bt.to_flax_layout(model, model.state_dict())["params"]
    _assert_trees_close(params, jax.tree_util.tree_map(
        np.asarray, new.params), 1e-6, 0.0, "new param")
