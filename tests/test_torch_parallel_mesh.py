"""The port's mesh and sharding rules (boosted_detr_torch/parallel/mesh.py
and sharding.py) against the JAX package's: ``make_mesh``'s shapes,
coordinates and errors on four gloo ranks against JAX's mesh over four of
its virtual devices, ``_spec_for`` on every parameter of a port DETR and
BoostedDETR against JAX's on the bridge-mapped Flax path, the
divisibility guard, and the rows that ``shard_batch`` and
``prefetch_to_device(sharding=)`` give each rank."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import boosted_detr_torch as bt
from boosted_detr_torch.data import pipeline as tpipe
from boosted_detr_torch.models import layers as tlayers
from boosted_detr_torch.parallel import mesh as tmesh
from boosted_detr_torch.parallel import sharding as tsharding
from boosted_detr_tpu.parallel import mesh as jmesh
from boosted_detr_tpu.parallel import sharding as jsharding
from torch_parallel_cases import run_ranks

torch.set_num_threads(2)

SHAPES = ({"data": 4, "model": 1}, {"data": 2, "model": 2},
          {"data": 1, "model": 4}, {"data": 3, "model": 2}, None)
SMALL = dict(image_size=(64, 64), backbone="tiny", backbone_width=0.25,
             num_encoder_blocks=2, num_decoder_blocks=2, encoder_dim=32,
             decoder_dim=32, num_encoder_heads=2, num_decoder_heads=2,
             num_object_preds=8, num_categories=12, num_attributes=8,
             max_objects=4, compute_dtype="float32")


def _mesh(shape, data=0, model=0):
    """A mesh at the given coordinates, without a process group (the
    rules and rows read only its shape and coordinates)."""
    return tmesh.Mesh(shape=dict(shape), coords={"data": data,
                                                 "model": model},
                      groups={"data": None, "model": None},
                      device=torch.device("cpu"))


def test_make_mesh_matches_jax_on_four_ranks(tmp_path):
    got = run_ranks("mesh_case", {"shapes": SHAPES}, 4, tmp_path)
    devices = jax.devices()[:4]
    for shape in SHAPES:
        try:
            jm = jmesh.make_mesh(shape, devices)
        except ValueError as exc:
            for rank in got:
                assert rank[str(shape)] == str(exc)
            continue
        for r, rank in enumerate(got):
            ours, coords = rank[str(shape)]
            assert ours == dict(jm.shape)
            # rank r is the device at (data, model) of JAX's array
            where = np.argwhere(jm.devices == devices[r])[0]
            assert (coords["data"], coords["model"]) == tuple(where)


def test_one_rank_without_a_process_group():
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.world == 1
    assert mesh.groups == {"data": None, "model": None}
    with pytest.raises(ValueError, match="mesh shape"):
        tmesh.make_mesh({"data": 2}, device="cpu")
    with mesh:  # a mesh of one rank changes nothing
        assert tmesh.data_shard() is None
        x = torch.arange(6.0).reshape(3, 2)
        assert tmesh.draw_global(lambda s: x[:s[0]], (3, 2)) is not None
        assert torch.equal(tmesh.data_sum(torch.tensor([1, 2])),
                           torch.tensor(3.0))


def _flax_path(model, name, p):
    """JAX's key path of the port's parameter ``name``."""
    tree = bt.to_flax_layout(model, {name: p})["params"]
    (path, _), = jax.tree_util.tree_flatten_with_path(tree)[0]
    return path


def _to_flax_spec(spec, ndim):
    # a Dense kernel is [in, out] in Flax, [out, in] here
    return tuple(reversed(spec)) if ndim == 2 else tuple(spec)


@pytest.mark.parametrize("family", ["detr", "boosted"])
def test_spec_for_matches_jax_on_every_parameter(family):
    cls = {"detr": bt.DETR, "boosted": bt.BoostedDETR}[family]
    model = cls(bt.ModelConfig(**SMALL), device="cpu")
    split = 0
    for name, p in model.named_parameters():
        want = tuple(jsharding._spec_for(_flax_path(model, name, p)))
        got = _to_flax_spec(tsharding._spec_for(name), p.dim())
        assert got == want, (name, got, want)
        split += bool(want)
    # q, k, v, output projections and both FFN denses, weights and the
    # column-split biases, in every attention block
    assert split > 20


def test_param_shardings_guard_and_pairs():
    """A leaf whose split axis does not divide is replicated, as JAX's
    guard does; here its pair is replicated with it, and an MHA whose heads
    do not divide stays whole."""
    mesh = _mesh({"data": 1, "model": 2})
    ffn = tlayers.FeedForwardBlock(6, 1e-3, torch.float32)
    specs = tsharding.param_shardings(ffn, mesh)
    assert specs == {"dense_relu.weight": ("model", None),
                     "dense_relu.bias": ("model",),
                     "dense_linear.weight": (None, "model"),
                     "dense_linear.bias": (), "layer_norm.weight": (),
                     "layer_norm.bias": ()}
    odd = tlayers.FeedForwardBlock(3, 1e-3, torch.float32)
    assert not any(tsharding.param_shardings(odd, mesh).values())
    jm = jmesh.make_mesh({"data": 4, "model": 2})
    jspec = jsharding.param_shardings(
        {"dense_relu": {"kernel": jax.numpy.zeros((3, 3))}}, jm)
    assert jspec["dense_relu"]["kernel"].spec == P()
    # 3 heads over 2 ranks: JAX splits the 6 features; the port keeps the
    # MHA whole
    mha = tlayers.MultiheadAttention(6, 3, torch.float32)
    assert not any(tsharding.param_shardings(mha, mesh).values())
    mha = tlayers.MultiheadAttention(8, 2, torch.float32)
    assert tsharding.param_shardings(mha, mesh)[
        "output_projection.weight"] == (None, "model")


def test_shard_module_keeps_each_ranks_slice():
    full = tlayers.MultiheadAttention(8, 2, torch.float32)
    for index in range(2):
        mha = tlayers.MultiheadAttention(8, 2, torch.float32)
        mha.load_state_dict(full.state_dict())
        weight = mha.query_projection.weight
        tsharding.shard_module(mha, _mesh({"data": 1, "model": 2},
                                          model=index))
        assert mha.num_heads == 1 and mha.query_projection.weight is weight
        rows = slice(index * 4, (index + 1) * 4)
        assert torch.equal(weight, full.query_projection.weight[rows])
        assert torch.equal(mha.query_projection.bias,
                           full.query_projection.bias[rows])
        assert torch.equal(mha.output_projection.weight,
                           full.output_projection.weight[:, rows])
        assert torch.equal(mha.output_projection.bias,
                           full.output_projection.bias)
        assert weight.tp_split[0] == 0
        assert mha.output_projection.weight.tp_split[0] == 1


def test_a_split_model_trains_only_under_its_mesh(tmp_path):
    """A DETR split over 'model' on two ranks: its step raises under the
    default mesh (both ranks on 'data', where the gradients' all-reduce
    would sum different slices of each split leaf) and under an explicit
    data mesh, and runs under the mesh it was split over."""
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32),
             "category_ids": rng.integers(2, 12, (2, 4)).astype(np.int32),
             "attribute_ids": rng.integers(0, 8, (2, 4, 4)).astype(np.int32),
             "bbox": rng.uniform(0.05, 0.45, (2, 4, 4)).astype(np.float32),
             "num_objects": np.asarray([1, 3], np.int32)}
    tp = {"data": 1, "model": 2}
    shapes = [None, {"data": 2, "model": 1}, tp]
    got = run_ranks("split_mismatch_case",
                    {"mesh": tp, "shapes": shapes, "batch": batch,
                     "cfg": dict(SMALL, matcher="pallas")}, 2, tmp_path)
    for out in got:
        for shape in shapes[:2]:
            assert "not this step's mesh's" in out[str(shape)], out
        assert out[str(tp)] == "ran"


def test_state_shardings_follow_the_parameters():
    mesh = _mesh({"data": 1, "model": 2})
    model = tlayers.FeedForwardBlock(4, 1e-3, torch.float32)
    tcfg = bt.TrainConfig(ema_decay=0.9)
    state = bt.TrainState.create(model, bt.make_optimizer(
        tcfg, model.parameters()), ema=True)
    model(torch.ones(2, 4)).sum().backward()
    state.optimizer.step()  # SGD's momentum buffers
    specs = tsharding.state_shardings(state, mesh)
    params = tsharding.param_shardings(model, mesh)
    assert specs["params"] == params == specs["ema_params"]
    for name, entries in specs["opt_state"].items():
        assert entries == {"momentum_buffer": params[name]}


def _batch(n):
    return {"image": np.arange(n * 6, dtype=np.float32).reshape(n, 2, 3),
            "num_objects": np.arange(n, dtype=np.int32),
            "image_path": np.asarray([f"{i}.jpg" for i in range(n)])}


@pytest.mark.parametrize("data", [0, 1, 2])
def test_shard_batch_gives_each_rank_its_rows(data):
    mesh = _mesh({"data": 3, "model": 2}, data=data, model=1)
    batch = _batch(6)
    got = tmesh.shard_batch(batch, mesh)
    rows = slice(2 * data, 2 * data + 2)
    assert isinstance(got, tmesh.ShardedBatch) and got.global_size == 6
    assert torch.equal(got["image"], torch.from_numpy(batch["image"][rows]))
    assert got["num_objects"].tolist() == [2 * data, 2 * data + 1]
    assert got["image_path"].tolist() == batch["image_path"][rows].tolist()
    prefetched = list(tpipe.prefetch_to_device(
        iter([batch, _batch(6)]), sharding=tmesh.batch_sharding(mesh)))
    for item in prefetched:
        assert item.global_size == 6
        for k in ("image", "num_objects"):
            assert torch.equal(item[k], got[k]), k
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_batch(_batch(4), mesh)


def test_global_batch_records_the_global_size():
    from boosted_detr_torch.parallel import multiprocess

    mesh = _mesh({"data": 4, "model": 1}, data=3)
    got = multiprocess.global_batch(_batch(2), tmesh.batch_sharding(mesh))
    assert got.global_size == 8 and got["image"].shape == (2, 2, 3)
    with pytest.raises(TypeError, match="batch_sharding"):
        multiprocess.global_batch(_batch(2), tmesh.replicated(mesh))
    assert multiprocess.feed_info() == {"process_index": 0,
                                        "process_count": 1}


def test_config_fields_unchanged():
    from boosted_detr_tpu import config as jconfig

    got = [(f.name, f.default) for f in dataclasses.fields(bt.TrainConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(jconfig.TrainConfig)]
    assert got == want
