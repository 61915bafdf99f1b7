"""Context-parallel attention (boosted_detr_torch/parallel/
context_parallel.py) against the JAX package's, on the CPU: four gloo
ranks (a mesh of 'model' = 4) each hold the whole q [2, 16, 32] and their
16 of the 64 keys and values, in both impls ("xla", the plain per-shard
partial, and "pallas", the port's ``fused_attention_with_lse``, here its
plain version); JAX runs ``context_parallel_attention`` on its 8 virtual
devices, mesh {"data": 2, "model": 4}, with its Pallas kernel in
interpret mode. Forward at 1e-5, the gradients of sum(out^2) at JAX's own
bound, 2e-3 (tests/test_sharding.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from boosted_detr_tpu.parallel import context_parallel as jcp
from boosted_detr_tpu.parallel import mesh as jmesh
from torch_parallel_cases import run_ranks

IMPLS = ("xla", "pallas")


def _inputs():
    rng = np.random.default_rng(0)
    return {name: rng.normal(size=shape).astype(np.float32)
            for name, shape in (("q", (2, 16, 32)), ("k", (2, 64, 32)),
                                ("v", (2, 64, 32)))}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    inputs = _inputs()
    mesh = jmesh.make_mesh({"data": 2, "model": 4})
    want = {}
    for impl in IMPLS:
        def loss(q, k, v, impl=impl):
            return jnp.sum(jcp.context_parallel_attention(
                q, k, v, mesh, axis="model", impl=impl,
                interpret=True) ** 2)

        args = [jnp.asarray(inputs[x]) for x in "qkv"]
        out = jcp.context_parallel_attention(*args, mesh, axis="model",
                                             impl=impl, interpret=True)
        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
        want[impl] = {"out": np.asarray(out),
                      **{f"d{x}": np.asarray(g) for x, g in zip("qkv",
                                                                grads)}}
    got = run_ranks("context_case", dict(inputs, impls=IMPLS,
                                         mesh={"data": 1, "model": 4}),
                    4, tmp_path_factory.mktemp("context"))
    return got, want


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_equals_jax(results, impl):
    got, want = results
    for rank, result in enumerate(got):  # the output is replicated
        np.testing.assert_allclose(result[impl]["out"], want[impl]["out"],
                                   atol=1e-5, rtol=0, err_msg=str(rank))


@pytest.mark.parametrize("impl", IMPLS)
def test_gradients_equal_jax(results, impl):
    """dq is summed over the axis, so every rank holds the whole of it;
    dk and dv stay with their shard and are put back in rank order."""
    got, want = results
    for rank, result in enumerate(got):
        err = np.abs(result[impl]["dq"] - want[impl]["dq"]).max()
        assert err < 2e-3, (rank, err)
    for name in ("dk", "dv"):
        whole = np.concatenate([r[impl][name] for r in got], axis=1)
        err = np.abs(whole - want[impl][name]).max()
        assert err < 2e-3, (name, err)
