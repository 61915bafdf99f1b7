"""Offline import of pretrained weights into the ResNet backbone.

Counterpart of boosted_detr_tpu/models/pretrained.py:50-197. Nothing is
downloaded: the user supplies a checkpoint file in one of two formats:

1. **npz**, the JAX package's documented layout: a ``numpy.savez``
   archive whose keys are the slash-joined Flax paths of the
   ``ResNetBackbone`` subtree, prefixed by the collection::

       params/stem/conv/kernel                     [7,7,3,64]   (HWIO)
       params/stem/norm/scale|bias                 [64]
       params/stage{S}_block{I}/conv{1,2,3}/conv/kernel
       params/stage{S}_block{I}/conv{1,2,3}/norm/scale|bias
       params/stage{S}_block{I}/proj/conv/kernel   (blocks that project)
       params/stage{S}_block{I}/proj/norm/scale|bias
       batch_stats/<same paths>/norm/mean|var

   ``save_backbone_npz`` writes exactly this layout from a port model, so
   an npz written by either package loads into the other; the bridge's
   rules carry it onto the port's names (HWIO -> OIHW).
2. **a torchvision-style ResNet-50 state dict** (``conv1.weight``,
   ``bn1.*``, ``layer{1-4}.{i}.conv{1-3}.weight``, ``layer{1-4}.{i}.bn{1-3}
   .*``, ``layer{1-4}.{i}.downsample.{0,1}.*``) in a ``torch.load``-able
   file. torchvision's OIHW is already the port's layout, so nothing is
   transposed; ``num_batches_tracked`` and the classifier ``fc.*`` are
   skipped. torchvision's ResNet-50 is v1.5 (stride on the 3x3), as
   ``BottleneckBlock``.

Pretrained ResNet weights need the classic ``stem='conv7'`` (a patchify
stem has another shape) and the checkpoint's ``backbone_width``; a
mismatch raises with the offending paths. Set ``ModelConfig.preprocessing``
to what the weights were trained with.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from boosted_detr_torch import bridge

Tree = Dict[str, object]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    return {f"{prefix}{'/'.join(path)}": value
            for path, value in bridge._leaves(tree)}


def _unflatten(flat: Mapping[str, np.ndarray]) -> Tree:
    tree: Tree = {}
    for key, value in flat.items():
        *scopes, leaf = key.split("/")
        node = tree
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = value
    return tree


def resnet_module(model: nn.Module) -> nn.Module:
    """The ``ResNetBackbone`` of a port model (``DETR``, ``BoostedDETR``,
    or a model with a ``detr`` child: ``DETRPanoptic``,
    ``DETRMultiClassifier``)."""
    detr = getattr(model, "detr", model)
    net = detr.backbone.net
    if detr.backbone.net_name != "resnet":
        raise ValueError("pretrained weights load into the ResNet backbone; "
                         f"this model has '{detr.backbone.net_name}'")
    return net


def save_backbone_npz(model: nn.Module, path: str) -> None:
    """Writes the model's ResNet backbone to ``path`` in the documented npz
    layout (Flax paths, HWIO kernels, ``batch_stats`` means and
    variances)."""
    net = resnet_module(model)
    trees = bridge.to_flax_layout(net, net.state_dict())
    flat = {}
    for collection in ("params", "batch_stats"):
        flat.update(_flatten(trees.get(collection, {}), f"{collection}/"))
    np.savez(path, **flat)


def resnet_from_npz(path: str) -> Tuple[Tree, Tree]:
    """(params, batch_stats) Flax subtrees of ``ResNetBackbone`` from the
    documented npz layout, as nested dicts of numpy arrays."""
    archive = np.load(path)
    params, stats = {}, {}
    for key in archive.files:
        collection, rest = key.split("/", 1)
        (params if collection == "params" else stats)[rest] = archive[key]
    return _unflatten(params), _unflatten(stats)


# a torchvision BatchNorm's entries, which the port's BatchNorm names alike
_TORCH_BN = ("weight", "bias", "running_mean", "running_var")


def resnet_from_torch(source) -> Dict[str, torch.Tensor]:
    """A torchvision-style ResNet-50 state dict (or a path to a
    ``torch.load``-able file holding one) -> the port ``ResNetBackbone``'s
    state dict entries, OIHW as they come. ``fc.*`` and
    ``num_batches_tracked`` are skipped; any other unknown key raises."""
    if isinstance(source, str):
        source = torch.load(source, map_location="cpu", weights_only=True)
    out: Dict[str, torch.Tensor] = {}
    for key, value in source.items():
        parts = key.split(".")
        if parts[-1] == "num_batches_tracked" or parts[0] == "fc":
            continue  # BatchNorm bookkeeping; the classifier head
        name = None
        if key == "conv1.weight":
            name = "stem.conv.weight"
        elif parts[0] == "bn1":
            name = f"stem.norm.{parts[1]}"
        elif parts[0].startswith("layer") and len(parts) >= 4:
            block = f"stage{int(parts[0][len('layer'):]) - 1}_block{parts[1]}"
            if parts[2].startswith("conv"):
                name = f"{block}.{parts[2]}.conv.weight"
            elif parts[2].startswith("bn"):
                name = f"{block}.conv{parts[2][2:]}.norm.{parts[3]}"
            elif parts[2:4] == ["downsample", "0"]:
                name = f"{block}.proj.conv.weight"
            elif parts[2:4] == ["downsample", "1"]:
                name = f"{block}.proj.norm.{parts[-1]}"
        if name is None or (".norm." in name
                            and name.split(".")[-1] not in _TORCH_BN):
            raise ValueError(f"unrecognized torch ResNet key '{key}'")
        out[name] = torch.as_tensor(value).detach().cpu()
    return out


def _from_flax(params: Tree, stats: Tree) -> Dict[str, torch.Tensor]:
    """Flax (params, batch_stats) subtrees -> port names, by the bridge's
    rules."""
    out = {}
    for collection, tree in (("params", params), ("batch_stats", stats)):
        for path, value in bridge._leaves(tree):
            key, value = bridge._map_leaf(collection, path, value)
            out[key] = torch.from_numpy(bridge._contiguous(value))
    return out


def load_pretrained_backbone(model: nn.Module, source: str) -> nn.Module:
    """Loads pretrained ResNet weights into ``model``'s backbone in place
    from ``source``: an ``.npz`` in the documented layout, or a torch
    state-dict file. Every path and shape is checked first: missing or
    extra paths, and shape mismatches, raise ``ValueError`` as JAX's
    (pretrained.py:140-197), naming ``stem='conv7'`` and
    ``backbone_width``. Running statistics load where the source has
    them. Returns ``model``."""
    net = resnet_module(model)
    if source.endswith(".npz"):
        incoming = _from_flax(*resnet_from_npz(source))
    else:
        incoming = resnet_from_torch(source)
    state = net.state_dict()
    where = "backbone.resnet"
    stats = {k for k in state if k.endswith(("running_mean", "running_var"))}
    have_stats = any(k in stats for k in incoming)
    for coll, names in (("params", set(state) - stats),
                        ("batch_stats", stats if have_stats else set())):
        got = {k for k in incoming if (k in stats) == (coll == "batch_stats")}
        missing, extra = sorted(names - got), sorted(got - names)
        if missing or extra:
            raise ValueError(
                f"pretrained {coll} mismatch under '{where}': "
                f"missing={missing[:5]}{'...' if len(missing) > 5 else ''} "
                f"extra={extra[:5]}{'...' if len(extra) > 5 else ''} "
                "(pretrained ResNet import needs stem='conv7', matching "
                "depths and backbone_width)")
    for k, v in incoming.items():
        if tuple(v.shape) != tuple(state[k].shape):
            raise ValueError(
                f"shape mismatch at {where}.{k}: checkpoint "
                f"{tuple(v.shape)} vs model {tuple(state[k].shape)} "
                "(stem='conv7' and backbone_width must match the "
                "checkpoint)")
    with torch.no_grad():
        for k, v in incoming.items():
            state[k].copy_(v.to(state[k].dtype))
    return model
