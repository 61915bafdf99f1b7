"""K3's float32 backward on the tensor cores (csrc/attention.cu,
``attn_dq_wide_tf32_kernel`` and ``attn_dkdv_wide_tf32_kernel``), on the
CPU: the TF32 split that stands for a float32 value as two TF32 values
(``_tf32_parts``: hi the word with its low 13 bits dropped, as the tensor
cores read it; lo the same of the exact remainder), the emulations of the
kernels' arithmetic (three TF32 products a product, in the kernels' order
of sums) against the plain versions at the float32 gates, why one TF32
product is not enough, and the route's names and constants against the
source. No JAX: the emulation against JAX's Pallas kernel is in
tests/test_torch_attention_wide.py, the kernels against both on the card
in tests/test_torch_attention_kernel.py.

    python -m pytest tests/test_torch_attention_tf32.py -q
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from boosted_detr_torch.ops import attention as ta

torch.set_num_threads(2)

SOURCE = (Path(ta.__file__).resolve().parents[1] / "csrc"
          / "attention.cu").read_text()
ONE = 1.0


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


# (x, hi, lo): a value already TF32 (lo 0); the tie between two TF32
# values, 1 + 2^-11 (truncation keeps 1, the whole half ulp goes to lo);
# all 23 fraction bits set, 2 - 2^-23 (no carry into the exponent: hi
# 2 - 2^-10, lo 2^-10 - 2^-23 cut to its top 11 bits); the tie's negative
# (the sign stays on both parts); a value whose remainder needs all 13
# dropped bits, 1 + 2^-11 + 2^-23 (lo keeps 2^-11 and drops 2^-23, which
# lies 12 bits below it).
SPLITS = [
    (1.5, 1.5, 0.0),
    (ONE + 2.0 ** -11, ONE, 2.0 ** -11),
    (2.0 - 2.0 ** -23, 2.0 - 2.0 ** -10, 2.0 ** -10 - 2.0 ** -21),
    (-(ONE + 2.0 ** -11), -ONE, -(2.0 ** -11)),
    (ONE + 2.0 ** -11 + 2.0 ** -23, ONE, 2.0 ** -11),
]


@pytest.mark.parametrize("x,hi,lo", SPLITS)
def test_tf32_split_of_hand_made_values(x, hi, lo):
    """hi is x as the tensor cores read it (the low 13 bits dropped, a
    truncation toward zero, never a carry), lo the same of x - hi; both
    are TF32 values (their low 13 bits zero)."""
    got_hi, got_lo = ta._tf32_parts(torch.tensor([x], dtype=torch.float32))
    assert got_hi.item() == hi and got_lo.item() == lo
    for part in (got_hi, got_lo):
        assert int(_bits(part).item()) & 0x1FFF == 0


def test_tf32_split_bound():
    """Over a million values of every magnitude and sign: x - hi is exact
    (it is what lo is cut from), and |x - hi - lo| <= 2^-21 |x|."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(1 << 20)
                          * np.exp2(rng.integers(-60, 60, 1 << 20)))
                         .astype(np.float32))
    hi, lo = ta._tf32_parts(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    exact = x.double() - hi.double()
    assert torch.equal((x - hi).double(), exact)
    assert ((exact - lo.double()).abs()
            <= 2.0 ** -21 * x.double().abs()).all()


def _gradient_inputs(bh, tq, tk, d, seed=0):
    """float32 (q, k, v, g, lse, delta) as the Function's backward hands
    them to the gradient wrappers."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bh, t, d)).astype(
        np.float32)) for t in (tq, tk, tk, tq))
    g_lse = torch.from_numpy(rng.standard_normal((bh, tq)).astype(np.float32))
    out, lse = ta.attention_fwd_reference(q, k, v)
    return q, k, v, g, lse, (g * out).sum(-1) - g_lse


def _emulated(args, d):
    """dq, dk, dv of the emulations on the inputs padded as the wrapper
    pads them, with the true 1/sqrt(D), sliced back."""
    scale = 1.0 / d ** 0.5
    padded = (*ta._padded(*args[:4]), *args[4:])
    dq = ta.attention_dq_emulation(*padded, scale=scale)
    dk, dv = ta.attention_dkdv_emulation(*padded, scale=scale)
    for t in (dq, dk, dv):
        assert not t[..., d:].any()  # the padded columns come out zero
    return tuple(t[..., :d] for t in (dq, dk, dv))


def _outside_float32_gate(got, want):
    """Values outside the card's float32 gradient gate (the GPU tests'
    1e-5 of the largest value, at least 1e-5, plus 1e-4 relative)."""
    atol = 1e-5 * max(want.abs().max().item(), 1.0)
    return int(((got - want).abs() > atol + 1e-4 * want.abs()).sum())


# ragged against the 32-row tiles and 64-row blocks; one query row; every
# head dim padded to 256 (160, and 192: ViT-B's 768 over 4 heads)
TF32_SHAPES = [(2, tq, 130, d) for d in (160, 192, 256) for tq in (70, 1)]


@pytest.mark.parametrize("bh,tq,tk,d", TF32_SHAPES)
def test_tf32_arithmetic_passes_the_float32_gates(bh, tq, tk, d):
    """Three TF32 products a product over 32-row tiles, S and dP summed 8
    dims a step, inside the float32 gates against the plain versions, at
    the head dims the card runs it at (a padded D = 256)."""
    args = _gradient_inputs(bh, tq, tk, d)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    want = (ta.attention_dq_reference(*args), want_dk, want_dv)
    got = _emulated(args, d)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _outside_float32_gate(a, b) == 0, name


def test_one_tf32_product_fails_the_float32_gates(monkeypatch):
    """Why three products: with hi hi alone (one TF32 rounding of each
    operand, ~2^-11 of a term), dq, dk and dv leave the gates that the
    three products pass."""
    args = _gradient_inputs(2, 70, 130, 256)
    want_dk, want_dv = ta.attention_dkdv_reference(*args)
    want = (ta.attention_dq_reference(*args), want_dk, want_dv)
    three = _emulated(args, 256)
    assert [_outside_float32_gate(a, b) for a, b in zip(three, want)] == [
        0, 0, 0]

    def hi_hi(a_parts, b_parts, out):
        for c0 in range(0, a_parts[0].shape[-1], 8):
            c = slice(c0, c0 + 8)
            out = out + a_parts[0][..., c] @ b_parts[0][..., c, :]
        return out

    monkeypatch.setattr(ta, "_tf32_product", hi_hi)
    one = _emulated(args, 256)
    outside = [_outside_float32_gate(a, b) for a, b in zip(one, want)]
    assert all(n > 0 for n in outside), outside


@pytest.mark.parametrize("d,dtype", [
    (256, torch.float32), (160, torch.float32), (384, torch.float32),
    (128, torch.float32), (256, torch.bfloat16)])
def test_emulations_follow_the_tf32_route_by_default(monkeypatch, d, dtype):
    """The route decides the emulations' arithmetic: they take the three
    TF32 products exactly where ``wide_gradient_kernels`` names the TF32
    kernels (float32 at a padded TF32_HEAD_DIM), and the bf16 kernels'
    elsewhere."""
    calls = []

    def counted(a_parts, b_parts, out):
        calls.append(1)
        return three(a_parts, b_parts, out)

    three = ta._tf32_product
    monkeypatch.setattr(ta, "_tf32_product", counted)
    args = _gradient_inputs(1, 40, 70, d, seed=3)
    args = tuple(t.to(dtype) for t in args[:4]) + args[4:]
    ta.attention_dq_emulation(*args)
    ta.attention_dkdv_emulation(*args)
    on_tf32 = d > ta.CHUNK and "tf32" in ta.wide_gradient_kernels(d,
                                                                  dtype)[0]
    assert bool(calls) == on_tf32 == ta._on_tf32(args[0])


@pytest.mark.parametrize("d,dtype,names", [
    (160, torch.float32, ("attn_dq_wide_tf32_kernel",
                          "attn_dkdv_wide_tf32_kernel")),
    (256, torch.float32, ("attn_dq_wide_tf32_kernel",
                          "attn_dkdv_wide_tf32_kernel")),
    (384, torch.float32, ("attn_dq_wide_kernel", "attn_dkdv_wide_kernel")),
    (512, torch.float32, ("attn_dq_wide_kernel", "attn_dkdv_wide_kernel")),
    (256, torch.bfloat16, ("attn_dq_wide_mma_kernel",
                           "attn_dkdv_wide_mma_kernel")),
])
def test_tf32_route_names_follow_the_source(d, dtype, names):
    """``wide_gradient_kernels(d, dtype)`` names kernels the source
    defines: float32 at a padded 256 the TF32 ones, elsewhere the
    CUDA-core ones; bf16 as before. The source's TF32_D is
    TF32_HEAD_DIM, and its CUDA-core launchers refuse that head dim."""
    assert ta.wide_gradient_kernels(d, dtype) == names
    for name in names:
        assert f"\n{name}(" in SOURCE
    assert int(re.search(r"constexpr int TF32_D = (\d+);", SOURCE)[1]) == (
        ta.TF32_HEAD_DIM)
    assert ta._on_tf32(torch.zeros(1, 1, d, dtype=dtype)) == (
        "tf32" in names[0])
    for kind in ("dq", "dkdv"):
        body = SOURCE.split(f"cudaError_t launch_{kind}_wide(")[1].split(
            "\n}\n")[0]
        assert "if (nc * CD == TF32_D) return cudaErrorInvalidValue;" in body


def test_tf32_constants_follow_the_source():
    """The emulation's 32-row tiles, 8-row steps and 32-dim slabs are the
    kernels' TF32_TILE, the K of wgmma's .tf32 shape and TF32_SLAB (over
    which the tensor cores sum before the registers do); the transposed
    copies
    store each group of 8 rows as 0, 2, 4, 6, 1, 3, 5, 7, the order in
    which an accumulator's values enter as TF32 A fragments."""
    for name, value in (("TF32_TILE", ta._TF32_TILE),
                        ("TF32_SLAB", ta._TF32_SLAB)):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             SOURCE)[1]) == value
    assert "m64n32k8.f32.tf32.tf32" in (
        Path(ta.__file__).resolve().parents[1] / "csrc" / "mma.cuh"
    ).read_text() and ta._TF32_STEP == 8
    assert [2 * r if r < 4 else 2 * r - 7 for r in range(8)] == [
        0, 2, 4, 6, 1, 3, 5, 7]
    assert "(l < 4 ? 2 * l : 2 * l - 7)" in SOURCE
    assert ta._TF32_HI == -(1 << 13) and "0xffffe000u" in (
        Path(ta.__file__).resolve().parents[1] / "csrc" / "mma.cuh"
    ).read_text()


def test_tf32_scratch_shapes():
    """The wrapper's scratch, in the order the entries take it: dq k's
    and v's lo, then k^T and its lo; dk/dv q's and dO's lo, then each
    transpose and its lo, the rows rounded up to 8."""
    k = torch.zeros(2, 13, 256)
    shapes = [tuple(t.shape) for t in ta._tf32_scratch(k, 1)]
    assert shapes == [(2, 13, 256)] * 2 + [(2, 256, 16)] * 2
    shapes = [tuple(t.shape) for t in ta._tf32_scratch(k, 2)]
    assert shapes == [(2, 13, 256)] * 2 + [(2, 256, 16)] * 4
