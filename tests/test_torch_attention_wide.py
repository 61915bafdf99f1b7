"""The fused attention (K3) at head dims over 128, on the CPU: the plain
versions and the tensor-core emulations at D = 160, 256 and 384 against
JAX's Pallas kernel in interpret mode (which pads D to a multiple of 128,
as the port's wrapper does: ``padded_head_dim``), and a small ViT DETR
whose blocks run one head of D = 256 through the fused route, its forward
and one train step against JAX's through the bridge. The kernels
themselves are held against these versions on the card by
tests/test_torch_attention_kernel.py."""

import dataclasses
import re

import jax
import numpy as np
import optax
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.ops import attention as ta
from boosted_detr_torch.train import steps as tsteps
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from boosted_detr_tpu.train import steps as jsteps
from test_torch_attention import (CARD_GRAD_GATE, CARD_LSE_GATE,
                                  CARD_OUT_GATE, F32, K3_GRAD_TOL, K3_TOL,
                                  SMALL, _assert_trees_close, _batch,
                                  _bf16_gradient_inputs, _calibrated, _close,
                                  _DT, _jax, _k3_inputs, _outside,
                                  _pallas_k3, _perturbed)
from test_torch_attention import interpret  # noqa: F401  (a fixture)

torch.set_num_threads(2)

# ragged against the 64-row tiles and the 32-row tiles of the wide dq and
# dk/dv
WIDE = [(2, 70, 130, 160), (2, 70, 130, 256), (2, 70, 130, 384)]
# past RESIDENT_MAX_HEAD_DIM the bf16 dq and dk/dv take the chunked kernels
CHUNKED = [(1, 40, 70, 512)]


@pytest.mark.parametrize("d,padded", [(129, 256), (160, 256), (256, 256),
                                      (300, 384), (384, 384), (1000, 1024),
                                      (80, 128), (48, 64), (128, 128)])
def test_head_dims_pad_as_the_tpu_kernel_does(d, padded):
    """Up to 128 the next built width; past it the next multiple of 128,
    the TPU kernel's padding of D (pallas_attention.py:86)."""
    assert ta.padded_head_dim(d) == padded
    x = torch.ones((1, 3, d))
    (p,) = ta._padded(x)
    assert p.shape == (1, 3, padded) and not p[..., d:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,tq,tk,d", WIDE)
def test_k3_matches_the_pallas_kernel_past_128(bh, tq, tk, d, dtype):
    """out, lse and the gradients of a random cotangent of both through
    ``fused_attention_with_lse`` on the CPU (the plain versions) against
    the Pallas kernels in interpret mode."""
    tdt = _DT[dtype][0]
    q, k, v, g, g_lse = _k3_inputs(bh, tq, tk, d)
    j_out, j_lse, *j_grads = _pallas_k3(bh, tq, tk, d, dtype)
    tin = [torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out, lse = ta.fused_attention_with_lse(*tin)
    torch.autograd.backward([out, lse], [torch.tensor(g).to(tdt),
                                         torch.tensor(g_lse)])
    _close(out, j_out, K3_TOL[dtype], "out")
    _close(lse, j_lse, K3_TOL["float32"], "lse")
    for name, t, j in zip("qkv", tin, j_grads):
        _close(t.grad, j, K3_GRAD_TOL[dtype], f"d{name}")


@pytest.mark.parametrize("bh,tq,tk,d", WIDE + CHUNKED)
def test_wide_tensor_core_arithmetic_passes_the_gates(bh, tq, tk, d):
    """The emulations on the padded tensors (the logits summed 128-wide
    chunk by chunk, 32-query tiles in dk/dv: the resident kernels up to
    D = 384 sum in the chunked kernels' order, and the chunked ones run
    from D = 512 on), with the true 1/sqrt(D), sliced back: inside the
    card's gates against the plain versions at D, and at the plain
    versions' tolerance against JAX's Pallas kernels in interpret mode."""
    scale = 1.0 / d ** 0.5
    q, k, v, g, lse, delta = _bf16_gradient_inputs(bh, tq, tk, d)
    qp, kp, vp, gp = ta._padded(q, k, v, g)
    assert qp.shape[-1] == ta.padded_head_dim(d) > ta.CHUNK
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


@pytest.mark.parametrize("d,route", [(129, ""), (256, ""), (300, ""),
                                     (384, ""), (385, "chunked_"),
                                     (512, "chunked_"), (1000, "chunked_")])
def test_wide_gradient_route_follows_the_source(d, route):
    """``wide_gradient_kernels`` and ``wide_forward_kernel`` name the
    kernels csrc/attention.cu launches: the resident ones up to
    RESIDENT_MAX_NC chunks, read from the source, the chunked ones past
    it; the launchers of the forward, dq and dk/dv branch on that
    constant's chunks."""
    from pathlib import Path

    src = (Path(ta.__file__).resolve().parents[1] / "csrc"
           / "attention.cu").read_text()
    nc = int(re.search(r"constexpr int RESIDENT_MAX_NC = (\d+);",
                       src).group(1))
    assert ta.RESIDENT_MAX_HEAD_DIM == nc * ta.CHUNK
    assert ta.wide_gradient_kernels(d) == (
        f"attn_dq_wide_{route}mma_kernel", f"attn_dkdv_wide_{route}mma_kernel")
    assert ta.wide_forward_kernel(d) == f"attn_fwd_wide_{route}mma_kernel"
    for name in (ta.wide_forward_kernel(d), *ta.wide_gradient_kernels(d)):
        assert f"\n{name}(" in src  # a kernel of that name is defined
    for kind in ("fwd", "dq", "dkdv"):
        # the launcher takes the resident kernel at every nc up to the
        # constant, then the chunked one
        body = src.split(f"cudaError_t launch_{kind}_wide(")[1].split(
            "\n}\n")[0]
        assert re.findall(rf"if \(bf && nc == (\d)\)\s+return "
                          rf"launch_{kind}_resident<(\d)>", body) == [
            (str(n), str(n)) for n in range(2, nc + 1)]
        assert f"attn_{kind}_wide_chunked_mma_kernel<<<" in body
    with pytest.raises(ValueError):
        ta.wide_gradient_kernels(128)
    with pytest.raises(ValueError):
        ta.wide_forward_kernel(128)


def test_chunked_logits_are_the_whole_product_to_rounding():
    """``_logits`` sums 128-wide chunks in order: the same products as one
    float32 matmul, summed in another order."""
    rng = np.random.default_rng(8)
    a, b = (torch.from_numpy(rng.standard_normal((2, n, 384)).astype(
        np.float32)).bfloat16().float() for n in (5, 7))
    whole = a @ b.transpose(1, 2)
    chunked = ta._logits(a, b)
    torch.testing.assert_close(chunked, whole, atol=2e-5, rtol=1e-6)
    assert torch.equal(ta._logits(a[..., :128], b[..., :128]),
                       a[..., :128] @ b[..., :128].transpose(1, 2))


# A ViT DETR whose two blocks run one head of width 256 (D = 256) through
# the fused route; the DETR's own attentions at its defaults.
VIT_D256 = dict(SMALL, backbone="vit_p16_d2_w256_h1", backbone_width=1.0)


def test_use_pallas_attention_at_d256_takes_the_fused_route():
    """``use_pallas_attention=True`` sends the ViT blocks' D = 256 (and the
    DETR's narrower heads) through ``attention_fwd``: 2 + 5 calls, two of
    them at D = 256, which the wrapper takes as built (no raise, no
    padding)."""
    model = bt.DETR(bt.ModelConfig(**VIT_D256), device="cpu").eval()
    dims = []
    fwd = ta.attention_fwd

    def counted(q, k, v):
        dims.append(q.shape[-1])
        return fwd(q, k, v)

    image = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32))
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(ta, "attention_fwd", counted)
        model(image)
    assert len(dims) == 7 and dims.count(256) == 2, dims
    assert ta.padded_head_dim(256) == 256


def test_vit_d256_detr_forward_and_train_step_match_jax(interpret):
    """The float32 ViT DETR at D = 256: the eval forward, then one
    flagship-recipe train step with ``freeze_bn_stats`` from calibrated
    statistics (the losses, every raw gradient leaf and the new
    parameters), the JAX side through its Pallas kernels in interpret
    mode, the port's through the plain versions of its kernels."""
    rng = np.random.default_rng(10)
    batch = _batch(rng)
    jcfg = jconfig.ModelConfig(**VIT_D256, matcher="hungarian")
    pcfg = bt.ModelConfig(**VIT_D256, matcher="pallas")
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
        lambda params: jax.tree_util.tree_map(jax.numpy.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    b = batch["image"].shape[0]
    jt = jconfig.TrainConfig(batch_size=b, freeze_bn_stats=True)
    tx = optax.chain(capture, jsteps.make_optimizer(jt, d_model=64))
    state = jsteps.TrainState.create(jvars["params"], jvars["batch_stats"],
                                     tx)
    new, jaux = jax.block_until_ready(jax.jit(
        jsteps.make_train_step(jmodel, jcfg, jt))(state, _jax(batch),
                                                  jax.random.PRNGKey(1)))

    raw = {}
    tcfg = bt.TrainConfig(batch_size=b, freeze_bn_stats=True)
    tstate = bt.TrainState.create(
        model, bt.make_optimizer(tcfg, model.parameters(), d_model=64))
    clip = tsteps.clip_by_per_variable_norm

    def keep_raw(grads, max_norm):
        raw.update({n: p.grad.clone() for n, p in model.named_parameters()})
        clip(grads, max_norm)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsteps, "clip_by_per_variable_norm", keep_raw)
        _, aux = bt.make_train_step(model, pcfg, tcfg)(
            tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in jaux:
        np.testing.assert_allclose(aux[k].item(), float(jaux[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    grads = bt.to_flax_layout(model, raw)["params"]
    _assert_trees_close(grads, jax.tree_util.tree_map(
        np.asarray, new.opt_state[0]), 1e-4, 1e-6, "grad")
    params = bt.to_flax_layout(model, model.state_dict())["params"]
    _assert_trees_close(params, jax.tree_util.tree_map(
        np.asarray, new.params), 1e-6, 0.0, "new param")
