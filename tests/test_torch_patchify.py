"""The port's patchify stem (boosted_detr_torch/ops/patchify.py) against the
JAX package's ``patchify_conv`` (ops/pallas_patchify.py), which runs its
Pallas kernels through the interpreter on the CPU: the forward, and the
gradient (``PatchifyConvFn`` against ``jax.grad`` of the custom VJP, whose
weight half is the ``_dw_kernel``). On a CPU tensor the port's wrappers
take their plain PyTorch versions, so these tests hold those versions, the
arithmetic the CUDA kernels repeat, against the TPU kernels. The kernels
themselves are held against the plain versions on the card by
test_torch_patchify_kernel.py."""

import jax
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
# K <= 768 terms of size ~0.1 differs: 1e-5 covers it. bf16: the inputs are
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
    # the ViT patch embed, scaled down: P = 16, Wo = 5 (no multiple of the
    # tensor-core kernel's 16-position tiles), N = 40 (none of 64)
    ((2, 32, 80, 3), 16, 40),
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


def _grads(x, w, g, dtype, clip01):
    """(dx, dw) of sum(out * g) on both sides, out in the weights' dtype."""
    tdt, jdt = _DT[dtype]
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(True)
    out = tp.PatchifyConvFn.apply(xt, wt, tdt, clip01)
    (out.float() * torch.from_numpy(g)).sum().backward()

    def loss(xj, wj):
        out = jp.patchify_conv(xj, wj, clip01=clip01)
        return jnp.sum(out.astype(jnp.float32) * g)

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                             jnp.asarray(w).astype(jdt))
    return ((xt.grad.numpy(), wt.grad.float().numpy()),
            (np.asarray(dx), np.asarray(jnp.asarray(dw, jnp.float32))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip01", [True, False])
@pytest.mark.parametrize("shape,patch,cout", [
    ((2, 32, 32, 3), 8, 16),   # the patchify8 stem, scaled down
    ((1, 20, 27, 3), 8, 8),    # SAME padding: JAX takes an ordinary conv
])
def test_gradient_matches_jax(shape, patch, cout, dtype, clip01):
    x, w = _inputs(shape, patch, cout, seed=2)
    ho, wo = -(-shape[1] // patch), -(-shape[2] // patch)
    g = np.random.default_rng(3).standard_normal(
        (shape[0], ho, wo, cout)).astype(np.float32)
    (dx, dw), (ref_dx, ref_dw) = _grads(x, w, g, dtype, clip01)
    assert dw.shape == ref_dw.shape == w.shape and dx.shape == x.shape
    # dW sums M <= 32 products of unit-scale values: float32 order only;
    # in bf16 both round identical inputs and g (g arrives in the output's
    # dtype), sum in float32 and round the result once (2**-8 relative).
    # dx is plain float32 in the kernel's VJP on both sides; where JAX
    # leaves its kernel for an ordinary conv (SAME padding), XLA's conv
    # transpose gives a bf16 dx, one rounding from the port's float32 one.
    f32 = dict(atol=1e-5, rtol=1e-5)
    tol = f32 if dtype == "float32" else dict(atol=2e-2, rtol=8e-3)
    np.testing.assert_allclose(dw, ref_dw, **tol)
    np.testing.assert_allclose(
        dx, ref_dx, **(f32 if jp.supported(x.shape, patch) else tol))
    if clip01:  # the clip's gradient is zero outside [0, 1]
        assert (dx[(x < 0) | (x > 1)] == 0).all()


def test_weight_gradient_exposes_its_float32_sum():
    x, _ = _inputs((2, 16, 16, 3), 8, 4, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 2, 2, 4)).astype(np.float32)).bfloat16()
    before = tp.patchify_conv_dw.launches
    dw, dw32 = tp.patchify_conv_dw(torch.from_numpy(x), g, 8,
                                   torch.bfloat16, clip01=True)
    assert tp.patchify_conv_dw.launches == before  # the plain version
    assert dw.dtype == torch.bfloat16 and dw32.dtype == torch.float32
    assert torch.equal(dw, dw32.bfloat16())
    with pytest.raises(ValueError, match="does not fit"):
        tp.patchify_conv_dw(torch.from_numpy(x), g[:, :1], 8, torch.bfloat16)


@pytest.mark.parametrize("x_shape,w_shape,dtype,want", [
    # the three shapes the main paths run: (rows, positions, tiles, blocks)
    ((8, 640, 640, 3), (8, 8, 3, 128), "bfloat16", (1, 80, 5, 2)),
    ((8, 1280, 1280, 3), (8, 8, 3, 128), "bfloat16", (1, 80, 5, 2)),
    ((8, 640, 640, 3), (16, 16, 3, 384), "bfloat16", (1, 40, 3, 6)),
    ((1, 48, 40, 3), (8, 8, 3, 72), "bfloat16", (6, 5, 3, 2)),
    ((5, 24, 1600, 3), (8, 8, 3, 72), "bfloat16", (1, 67, 5, 2)),
    ((5, 24, 1600, 3), (8, 8, 3, 200), "bfloat16", (1, 40, 3, 6)),
    # the CUDA-core kernel keeps everything else
    ((8, 640, 640, 3), (8, 8, 3, 128), "float32", None),   # TF32 otherwise
    ((2, 64, 48, 3), (4, 4, 3, 64), "bfloat16", None),     # P * C_in = 12
    ((1, 100, 84, 3), (8, 8, 3, 24), "bfloat16", None),    # SAME padding
    ((1, 64, 64, 3), (8, 8, 3, 20), "bfloat16", None),     # N % 8
    ((1, 8, 8, 8), (1, 1, 8, 16), "bfloat16", None),       # k = 8, not 16
    ((1, 16, 16384, 3), (16, 16, 3, 8), "float32", None),
])
def test_route_choice_is_a_pure_function_of_the_shapes(x_shape, w_shape,
                                                       dtype, want):
    """bfloat16 weights with P dividing the image and P * C_in a multiple
    of 8 go to the tensor cores, everything else to the CUDA-core kernel;
    decided from shapes and dtype alone, so it needs no card."""
    plan = tp.tensor_core_plan(x_shape, w_shape, _DT[dtype][0])
    if want is None:
        assert plan is None
        return
    assert plan[:4] == want
    assert plan.rows * plan.seg <= 16 * plan.tiles
    assert plan.smem <= tp.SMEM_LIMIT
    if x_shape[2] // w_shape[0] <= tp.MMA_POSITIONS[plan.channel_blocks]:
        assert plan.seg == x_shape[2] // w_shape[0]  # whole rows


def test_tensor_core_plan_counts_the_shared_memory():
    # 640px stem: 2 image rows of 80 * 24 float32 values a slab, 80
    # positions of 112 bytes, two weight slabs of 48 rows of 136 bf16, and
    # two ints a position
    plan = tp.tensor_core_plan((8, 640, 640, 3), (8, 8, 3, 128),
                               torch.bfloat16)
    assert plan.smem == 4 * 2 * 1920 + 80 * 112 + 2 * 48 * 136 * 2 + 80 * 8
    # P = 16: one image row of 40 * 48 values a slab, 48 positions (40
    # live), 392-wide weight slabs
    plan = tp.tensor_core_plan((8, 640, 640, 3), (16, 16, 3, 384),
                               torch.bfloat16)
    assert plan.smem == 4 * 1920 + 48 * 112 + 2 * 48 * 392 * 2 + 48 * 8
    # a block that cannot fit is left to the other kernel, which refuses it
    assert tp.tensor_core_plan((1, 128, 128 * 80, 48), (128, 128, 48, 8),
                               torch.bfloat16) is None


# The tensor-core weight gradient's arithmetic (``patchify_dw_emulation``)
# against JAX's ``_dw_kernel`` in interpret mode, through the gradient of
# ``patchify_conv`` as above, with bf16 weights: P=8 -> 128 at Wo = 75
# (ragged 16-position steps, 7 stages of one row) and P=16 -> 384 (two
# stages: 5 rows, then 1). The kernel's plan takes a chunk a stage; the
# emulation also runs the stages as one chunk, and as chunks of 2 (a
# ragged last one at P=8).
_EMULATED_DW = {8: ((1, 56, 600, 3), 128), 16: ((2, 48, 240, 3), 384)}
_jax_dw_cache = {}


def _jax_dw(patch):
    """(x, g, JAX's bf16 dW) at the patch's shape, computed once."""
    if patch not in _jax_dw_cache:
        shape, cout = _EMULATED_DW[patch]
        x, w = _inputs(shape, patch, cout, seed=6)
        g = np.random.default_rng(7).standard_normal(
            (shape[0], shape[1] // patch, shape[2] // patch, cout)).astype(
                np.float32)

        def loss(wj):
            out = jp.patchify_conv(jnp.asarray(x), wj, clip01=True)
            return jnp.sum(out.astype(jnp.float32) * g)

        dw = jax.grad(loss)(jnp.asarray(w).astype(jnp.bfloat16))
        _jax_dw_cache[patch] = (x, g, np.array(jnp.asarray(dw, jnp.float32)))
    return _jax_dw_cache[patch]


@pytest.mark.parametrize("per_chunk", [1, 2, 8])
@pytest.mark.parametrize("patch", [8, 16])
def test_dw_emulation_matches_jax_kernel(patch, per_chunk):
    x, g, ref_dw = _jax_dw(patch)
    shape, cout = _EMULATED_DW[patch]
    xt = torch.from_numpy(x)
    gt = torch.from_numpy(g).bfloat16()  # the cotangent of a bf16 output
    plan = tp.dw_tensor_core_plan(shape, gt.shape, patch, torch.bfloat16)
    stages = plan.stages(gt.shape[0] * gt.shape[1], gt.shape[2])
    assert plan.per_chunk == 1 and plan.chunks == stages > 1
    plan = plan._replace(per_chunk=per_chunk,
                         chunks=-(-stages // per_chunk))
    dw, dw32 = tp.patchify_dw_emulation(xt, gt, patch, torch.bfloat16,
                                        clip01=True, plan=plan)
    ref, ref32 = tp.patchify_conv_dw_reference(xt, gt, patch, torch.bfloat16,
                                               clip01=True)
    # the chip's gate: the float32 sums within 1e-5 of the summed
    # |products| plus 1e-6, and each cast within one bf16 ulp more
    patches, _ = tp._patch_matrix(xt, patch, torch.bfloat16, True)
    scale = (patches.float().abs().t()
             @ gt.reshape(-1, cout).float().abs()).reshape(dw32.shape)
    bound = 1e-5 * scale + 1e-6
    assert ((dw32 - ref32).abs() <= bound).all()
    for want in (torch.from_numpy(ref_dw), ref.float()):
        assert ((dw.float() - want).abs()
                <= bound + 2.0 ** -7 * want.abs()).all()


@pytest.mark.parametrize("x_shape,g_shape,patch,want", [
    # the three shapes the main paths run: (rows, seg, chunks, per_chunk)
    ((8, 640, 640, 3), (8, 80, 80, 128), 8, (1, 80, 128, 5)),
    ((8, 1280, 1280, 3), (8, 160, 160, 128), 8, (1, 80, 128, 20)),
    ((8, 640, 640, 3), (8, 40, 40, 384), 16, (2, 40, 11, 15)),
    # a width whose rows the CUDA-core kernel cannot stage
    ((1, 16, 4096, 3), (1, 1, 256, 8), 16, (1, 64, 4, 1)),
])
def test_dw_plan_covers_every_position_once(x_shape, g_shape, patch, want):
    plan = tp.dw_tensor_core_plan(x_shape, g_shape, patch, torch.bfloat16)
    assert (plan.rows, plan.seg, plan.chunks, plan.per_chunk) == want
    assert plan.smem <= tp.SMEM_LIMIT
    assert plan.rows * plan.seg <= tp.DW_MMA_STAGE
    total, wo = g_shape[0] * g_shape[1], g_shape[2]
    seen = torch.zeros(total * wo, dtype=torch.int32)
    for c in range(plan.chunks):
        for st in range(c * plan.per_chunk,
                        min((c + 1) * plan.per_chunk,
                            plan.stages(total, wo))):
            lo, hi = plan.span(st, total, wo)
            assert 0 < hi - lo <= plan.rows * plan.seg
            seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("x_shape,g_shape,patch,dtype", [
    ((8, 640, 640, 3), (8, 80, 80, 128), 8, torch.float32),  # TF32 else
    ((2, 64, 48, 3), (2, 16, 12, 64), 4, torch.bfloat16),    # P * C_in = 12
    ((1, 100, 84, 3), (1, 13, 11, 24), 8, torch.bfloat16),   # SAME padding
    ((1, 64, 64, 3), (1, 8, 8, 20), 8, torch.bfloat16),      # N % 8
])
def test_dw_plan_leaves_the_rest_to_the_cuda_core_kernel(x_shape, g_shape,
                                                         patch, dtype):
    assert tp.dw_tensor_core_plan(x_shape, g_shape, patch, dtype) is None


def test_ctypes_signatures_match_the_c_entry_points():
    """Each C entry point of csrc/patchify.cu takes the arguments its
    ctypes signature passes: a pointer, an int or a long long each."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(tp.__file__).resolve().parents[1] / "csrc"
           / "patchify.cu").read_text()
    c_types = {"void*": ctypes.c_void_p, "const void*": ctypes.c_void_p,
               "int": ctypes.c_int, "long long": ctypes.c_longlong}
    results = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
               "const char*": ctypes.c_char_p}
    exported = src[src.index('extern "C" {'):]
    found = {}
    for ret, name, params in re.findall(
            r"^(int|long long|const char\*) (\w+)\(([^)]*)\)\s*\{", exported,
            flags=re.M):
        args = [c_types[" ".join(p.split()[:-1])]
                for p in params.replace("\n", " ").split(",")]
        found[name] = (args, results[ret])
    assert found == tp._SIGNATURES


@pytest.mark.parametrize("patch,c_out", [(8, 128), (16, 384)])
def test_plain_version_sums_in_the_tensor_core_order(patch, c_out):
    """On a tensor-core geometry the plain forward is ``mma_step_sums``:
    each 16-wide step of k exact and rounded toward zero (never above the
    exact sum in magnitude, within one float32 ulp of it), the steps added
    in k order; the result within float32 rounding of the exact sum. On a
    geometry the CUDA-core kernel takes it stays one float32 matmul."""
    rng = np.random.default_rng(patch)
    x = torch.from_numpy(rng.uniform(-0.1, 1.1, (2, 2 * patch, 3 * patch, 3))
                         .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((patch, patch, 3, c_out))
                          * 0.1).astype(np.float32)).bfloat16()
    assert tp.tensor_core_plan(tuple(x.shape), tuple(w.shape), w.dtype)
    out = tp.patchify_conv_reference(x, w, out_dtype=torch.float32,
                                     clip01=True)
    patches, _ = tp._patch_matrix(x, patch, torch.bfloat16, True)
    a, b = patches.double(), w.reshape(-1, c_out).double()
    acc = torch.zeros(a.shape[0], c_out, dtype=torch.float32)
    for s in range(0, a.shape[1], tp.MMA_K):
        exact = a[:, s:s + tp.MMA_K] @ b[s:s + tp.MMA_K]
        part = tp.mma_step_sums(patches[:, s:s + tp.MMA_K],
                                w.reshape(-1, c_out)[s:s + tp.MMA_K])
        assert (part.double().abs() <= exact.abs()).all()
        ulp = torch.nextafter(part.abs(), torch.full_like(part, np.inf)) \
            - part.abs()
        assert ((exact - part.double()).abs() <= ulp.double()).all()
        acc = acc + part
    np.testing.assert_array_equal(out.reshape(acc.shape).numpy(),
                                  acc.numpy())
    exact = (a @ b).float().reshape(out.shape)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=1e-6,
                               atol=1e-6)
    # float32 weights: the CUDA-core kernel's geometry, one matmul
    w32 = w.float()
    assert tp.tensor_core_plan(tuple(x.shape), tuple(w32.shape),
                               w32.dtype) is None
    patches32, _ = tp._patch_matrix(x, patch, torch.float32, True)
    np.testing.assert_array_equal(
        tp.patchify_conv_reference(x, w32, clip01=True).reshape(-1, c_out)
        .numpy(), (patches32 @ w32.reshape(-1, c_out)).numpy())


_SOURCE = None


def _c_formulas():
    """The CUDA-core kernels' shared-memory rule, read from the text of
    csrc/patchify.cu and translated to Python: ``image_bytes``,
    ``patchify_smem_bytes`` (the forward), ``dw_rows_staged``,
    ``dw_image_floats`` and ``dw_smem`` (the weight gradient), with the
    constants they read."""
    import re
    from pathlib import Path

    global _SOURCE
    if _SOURCE is None:
        _SOURCE = (Path(tp.__file__).resolve().parents[1] / "csrc"
                   / "patchify.cu").read_text()
    src = _SOURCE
    consts = {}
    for name, expr in re.findall(r"constexpr int (DW_\w+) = ([^;]*);", src):
        consts[name] = eval(expr.split("//")[0], {}, dict(consts))  # noqa: S307
    names = ("image_bytes", "patchify_smem_bytes", "dw_rows_staged",
             "dw_image_floats", "dw_smem")
    space = dict(consts)
    for name in names:
        params, body = re.search(
            rf"(?:inline )?(?:long long|int) {name}\(([^)]*)\) \{{(.*?)\n\}}",
            src, flags=re.S).groups()
        args = ", ".join(p.split()[-1] for p in params.split(","))
        body = re.sub(r"//[^\n]*", "", body)
        body = body.replace("static_cast<long long>", "")
        body = body.replace("4LL", "4").replace("/", "//")
        body = body.replace("(w_bf16 ? 2 : 4)", "(2 if w_bf16 else 4)")
        body = body.replace("rows < P ? rows : P", "min(rows, P)")
        assert "?" not in body, body
        lines = [re.sub(r"^(const )?(long long|int) ", "",
                        " ".join(st.split()))
                 for st in body.split(";") if st.strip()]
        exec(f"def {name}({args}):\n" + "".join(  # noqa: S102
            f"    {ln}\n" for ln in lines), space)
    return space


@pytest.mark.parametrize("p,c_in,wo,c_out,w_bf16", [
    (8, 3, 80, 128, True), (8, 3, 80, 128, False), (4, 3, 160, 64, True),
    (16, 3, 40, 384, False), (8, 3, 11, 20, False), (16, 3, 4, 384, True),
    (8, 3, 160, 128, False),
    (16, 3, 256, 384, False),  # W = 4096: 786 KB of whole rows
    (16, 3, 256, 8, False),
    (4, 3, 2048, 64, False),   # W = 8192: 393 KB of whole rows
    (4, 3, 2048, 64, True), (32, 3, 300, 128, False), (2, 1, 50000, 4, False)])
def test_fwd_span_plan_is_the_c_sources_rule(p, c_in, wo, c_out, w_bf16):
    """Today's cut (whole rows, the slice halved down to 4 channels) where
    it fits, the same numbers as before; else a span of the row at the
    widest slice that leaves ``MIN_SPAN`` positions, as few spans as fit;
    the shared memory always the C source's count."""
    c = _c_formulas()
    smem = c["patchify_smem_bytes"]
    plan = tp.fwd_span_plan(p, c_in, wo, c_out, w_bf16)
    assert plan.smem == smem(p, c_in, plan.span, plan.channels, w_bf16)
    assert plan.smem <= tp.SMEM_LIMIT
    top = 4
    while top < min(c_out, 128):
        top *= 2
    whole = [bn for bn in (128, 64, 32, 16, 8, 4)
             if bn <= top and smem(p, c_in, wo, bn, w_bf16) <= tp.SMEM_LIMIT]
    if whole:
        assert (plan.channels, plan.span) == (whole[0], wo)
        return
    spans = -(-wo // plan.span)
    assert plan.span == -(-wo // spans) < wo
    assert smem(p, c_in, -(-wo // (spans - 1)), plan.channels,
                w_bf16) > tp.SMEM_LIMIT
    wider = 2 * plan.channels
    if wider <= top:
        assert smem(p, c_in, min(wo, tp.MIN_SPAN), wider,
                    w_bf16) > tp.SMEM_LIMIT
    assert plan.span >= min(wo, tp.MIN_SPAN) or plan.channels == 4


@pytest.mark.parametrize("p,c_in,wo", [
    (8, 3, 80), (4, 3, 160), (16, 3, 40), (8, 3, 160), (8, 3, 11),
    (16, 3, 256),   # W = 4096: 278 KB of whole rows
    (4, 3, 2048),   # W = 8192
    (16, 64, 100), (2, 1, 90000)])
def test_dw_span_plan_is_the_c_sources_rule(p, c_in, wo):
    c = _c_formulas()
    assert (tp.DW_TILE_K, tp.DW_TILE_N) == (c["DW_BK"], c["DW_BN"])
    plan = tp.dw_span_plan(p, c_in, wo)
    assert plan.channels == c["DW_BN"]
    assert plan.smem == c["dw_smem"](p, c_in, plan.span) <= tp.SMEM_LIMIT
    spans = -(-wo // plan.span)
    assert plan.span == -(-wo // spans)
    if spans > 1:
        assert c["dw_smem"](p, c_in, -(-wo // (spans - 1))) > tp.SMEM_LIMIT


def test_span_plans_name_the_geometry_that_does_not_fit():
    # one position of P = 64 over 512 input channels: rows of 32,768
    # values, two of which a k tile of the weight gradient touches
    with pytest.raises(ValueError, match="P=64, C_in=512"):
        tp.fwd_span_plan(64, 512, 10, 8, False)
    with pytest.raises(ValueError, match="P=64, C_in=512"):
        tp.dw_span_plan(64, 512, 10)
