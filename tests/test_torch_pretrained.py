"""The port's pretrained-backbone import (boosted_detr_torch/models/
pretrained.py) against the JAX package's on the CPU: the documented npz
layout round trip both ways (an npz written by either package loads into
the other and gives both the same forward), a random torchvision-style
ResNet state dict loaded into both packages (equal forwards), and the
mismatch errors. The model is a small DETR with the ``conv7`` stem (the
one pretrained ResNet weights fit): tests/test_torch_boosted.py's TINY
widths at ``backbone_width`` 0.01 (every ResNet width at its floor of 32),
64x64 images, float32; JAX runs under ``jax.jit``."""

import jax
import numpy as np
import pytest
import torch

import boosted_detr_torch as bt
from boosted_detr_torch.models import pretrained as tpt
from boosted_detr_tpu import config as jconfig
from boosted_detr_tpu.models import pretrained as jpt
from boosted_detr_tpu.models.detr import DETR as JaxDETR
from test_torch_boosted import TINY, tiny_variables

torch.set_num_threads(2)

CFG = dict(TINY, num_decoder_blocks=1, stem="conv7", use_pallas_stem=False)
# float32 through 17 conv blocks and the transformer: sums in other orders
F32 = dict(atol=1e-5, rtol=1e-5)


def _image():
    return np.random.default_rng(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    image = _image()
    jmodel = JaxDETR(jconfig.ModelConfig(**CFG))
    return {"image": image, "jmodel": jmodel,
            "apply": jax.jit(jmodel.apply),
            "variables": tiny_variables(jmodel, image, seed=3),
            "other": tiny_variables(jmodel, image, seed=4)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(variables):
    model = bt.DETR(bt.ModelConfig(**CFG), device="cpu").eval()
    bt.load_flax_variables(model, variables)
    return model


def _forwards_agree(reference, jax_variables, model):
    want = reference["apply"](jax_variables, reference["image"])
    with torch.inference_mode():
        got = model(torch.from_numpy(reference["image"]))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   **F32, err_msg=key)


def test_jax_npz_loads_into_the_port(reference, tmp_path):
    path = str(tmp_path / "backbone.npz")
    jpt.save_backbone_npz(reference["variables"], path)
    model = _port(reference["other"])
    assert bt.load_pretrained_backbone(model, path) is model
    # JAX's model with the same backbone: the pretrained one in the other
    # weights' tree
    merged = jpt.load_pretrained_backbone(_np_tree(reference["other"]), path)
    _forwards_agree(reference, merged, model)
    # and the backbone is the saved one, leaf by leaf
    params, stats = tpt.resnet_from_npz(path)
    jparams, jstats = jpt.resnet_from_npz(path)
    for got, want in ((params, jparams), (stats, jstats)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(_np_tree(want))
        jax.tree_util.tree_map(np.testing.assert_array_equal, got,
                               _np_tree(want))


def test_port_npz_loads_into_jax(reference, tmp_path):
    path = str(tmp_path / "port.npz")
    source = _port(reference["variables"])
    tpt.save_backbone_npz(source, path)
    archive = np.load(path)
    assert "params/stem/conv/kernel" in archive.files
    assert archive["params/stem/conv/kernel"].shape == (7, 7, 3, 32)  # HWIO
    assert any(k.startswith("batch_stats/") and k.endswith("/norm/var")
               for k in archive.files)
    merged = jpt.load_pretrained_backbone(_np_tree(reference["other"]), path)
    model = _port(reference["other"])
    bt.load_pretrained_backbone(model, path)
    _forwards_agree(reference, merged, model)
    # the saved tree is the JAX backbone the port was loaded from
    want = reference["variables"]["params"]["backbone"]["resnet"]
    got = merged["params"]["backbone"]["resnet"]
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np_tree(got),
                           _np_tree(want))


def _torchvision_name(key):
    """The port ResNet's state-dict entry -> torchvision's ResNet-50 key."""
    parts = key.split(".")
    bn = {"weight": "weight", "bias": "bias", "running_mean":
          "running_mean", "running_var": "running_var"}
    if parts[0] == "stem":
        return "conv1.weight" if parts[1] == "conv" else f"bn1.{parts[2]}"
    stage, block = parts[0][len("stage"):].split("_block")
    head = f"layer{int(stage) + 1}.{block}"
    if parts[1] == "proj":
        return (f"{head}.downsample.0.weight" if parts[2] == "conv"
                else f"{head}.downsample.1.{bn[parts[3]]}")
    k = parts[1][len("conv"):]
    return (f"{head}.conv{k}.weight" if parts[2] == "conv"
            else f"{head}.bn{k}.{bn[parts[3]]}")


def _random_torchvision_dict(model, seed):
    """A torchvision-style state dict at the port ResNet's shapes, with the
    BatchNorm counters and a classifier head, every value drawn."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in tpt.resnet_module(model).state_dict().items():
        shape = tuple(value.shape)
        if key.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, shape)
        elif key.endswith("conv.weight"):
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[1:]))
        elif key.endswith("norm.weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.2 * rng.standard_normal(shape)
        name = _torchvision_name(key)
        out[name] = torch.from_numpy(v.astype(np.float32))
        if name.endswith("running_var"):
            out[name.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    out["fc.weight"] = torch.zeros(10, 32)
    out["fc.bias"] = torch.zeros(10)
    return out


def test_torchvision_state_dict_loads_into_both(reference, tmp_path):
    model = _port(reference["other"])
    state = _random_torchvision_dict(model, seed=5)
    path = str(tmp_path / "resnet50.pt")
    torch.save(state, path)
    bt.load_pretrained_backbone(model, path)
    merged = jpt.load_pretrained_backbone(_np_tree(reference["other"]), path)
    _forwards_agree(reference, merged, model)
    # OIHW as it comes: no transpose on the port's side
    net = tpt.resnet_module(model)
    assert torch.equal(net.stem.conv.weight, state["conv1.weight"])
    assert torch.equal(net.stage1_block0.proj.norm.running_var,
                       state["layer2.0.downsample.1.running_var"])
    entries = tpt.resnet_from_torch(state)
    assert set(entries) == set(net.state_dict())


def test_mismatches_raise_as_jax(reference, tmp_path):
    model = _port(reference["other"])
    state = _random_torchvision_dict(model, seed=6)
    # the patchify stem: another stem shape and no max pool -> paths differ
    path = str(tmp_path / "resnet50.pt")
    torch.save(state, path)
    patchify = bt.DETR(bt.ModelConfig(**dict(CFG, stem="patchify8")),
                       device="cpu")
    with pytest.raises(ValueError, match="stem='conv7'"):
        bt.load_pretrained_backbone(patchify, path)
    # another width: the same paths, other shapes
    quarter, half = (bt.DETR(bt.ModelConfig(**dict(CFG, backbone_width=w)),
                             device="cpu") for w in (0.25, 0.5))
    torch.save(_random_torchvision_dict(half, seed=7), path)
    with pytest.raises(ValueError, match="shape mismatch.*backbone_width"):
        bt.load_pretrained_backbone(quarter, path)
    torch.save(state, path)
    # a key torchvision's ResNet does not have
    torch.save(dict(state, **{"layer1.0.odd.weight": torch.zeros(1)}), path)
    with pytest.raises(ValueError, match="unrecognized torch ResNet key"):
        bt.load_pretrained_backbone(model, path)
    with pytest.raises(ValueError, match="ResNet backbone"):
        bt.load_pretrained_backbone(bt.DETR(bt.ModelConfig(
            **dict(CFG, backbone="tiny")), device="cpu"), path)
    # a missing entry: the JAX message, naming the path
    del state["layer1.0.conv2.weight"]
    torch.save(state, path)
    with pytest.raises(ValueError, match="missing=.*stage0_block0.conv2"):
        bt.load_pretrained_backbone(model, path)
