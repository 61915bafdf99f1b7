"""Carries the JAX package's trained weights into the port.

``load_flax_variables(model, variables)`` takes a Flax variable tree
``{"params": ..., "batch_stats": ...}`` given as nested dicts of numpy
arrays (the port does not import Flax; a caller turns the Flax tree into
plain dicts, e.g. with ``jax.tree_util.tree_map(np.asarray, variables)``)
and fills the port module's ``state_dict``. The port's modules carry the
Flax scope names, so a leaf at ``a/b/kernel`` lands at ``a.b.weight``:

- Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- BatchNorm ``scale``/``bias`` and ``mean``/``var`` (``batch_stats``) ->
  ``weight``/``bias`` and ``running_mean``/``running_var``;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``; the bias-free
  QK-norm (``attn/q_norm/scale``, ``attn/k_norm/scale``) has a ``weight``
  only;
- ``positional_encoding``, ``positional_embedding`` (the ViT's) and
  ``object_queries`` keep their names.

``BoostedDETR``'s scopes are the Flax ones and map by the same rules:
``encoder_{i}`` (or ``encoder_shared``), ``decoder_prep``,
``decoder_block_{i}``, ``category_head_{i}``, ``attribute_head_{i}`` and
``box_head_{i}``, beside ``backbone`` and ``neck``.

The ViT backbone's leaves follow the same rules: ``vit/patch_embed``
(``kernel``, ``bias``: the patchify kernel's route and the plain conv's
share the tree), ``vit/positional_embedding``, ``vit/block_i/{ln1, ln2,
attn, mlp_in, mlp_out}``, ``vit/ln_final`` and ``vit/reduce``.

So do the other backbones and norms: a depthwise or grouped Conv
``kernel`` [kh, kw, in / groups, out] (depthwise: [kh, kw, 1, C]) becomes
OIHW [out, in / groups, kh, kw] by the same transpose; GroupNorm's
``norm/gn/{scale,bias}`` -> ``norm.gn.{weight,bias}``; the
weight-standardised conv's ``conv/gain`` and ``BottleneckBlock``'s scalar
``skip_gain`` (shape ``()``) and the squeeze-excite ``se/{reduce,expand}/
{kernel,bias}`` keep their names. A model with no BatchNorm (``skipinit``,
``groupnorm``) has no ``batch_stats`` collection.

``DETRPanoptic``'s tree maps by the same rules: ``detr/...`` lands on
the ``detr.`` prefix, beside ``panoptic_attention/{query,key}_projection``,
``panoptic_neck/{down0,down1,down2}/{conv,norm}``,
``panoptic_neck/{up2,up1,up0}/{deconv,norm}`` and
``panoptic_neck/mask_conv``; the pre-trainer's (``DETRMultiClassifier``)
is ``detr/<trunk>`` and ``classifier_head``. One rule of its own: a
ConvTranspose ``deconv/kernel`` [kh, kw, in, out], which Flax correlates
unflipped, becomes torch's ``conv_transpose2d`` weight [in, out, kh, kw]
with the spatial axes flipped.

It raises on a Flax leaf with no counterpart and on a port entry left
unfilled, so a renamed module cannot slip through with its random init.

``to_flax_layout(model, tensors)`` is the inverse: a dict keyed by the
port's names (gradients, parameters, running statistics) becomes the Flax
tree ``{"params": ..., "batch_stats": ...}`` of numpy arrays, so that a
test compares the two packages leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (str(key),))
        else:
            yield path + (str(key),), np.asarray(value)


def _contiguous(value: np.ndarray) -> np.ndarray:
    """A C-contiguous copy that keeps a 0-d leaf (``skip_gain``) 0-d:
    ``np.ascontiguousarray`` alone returns it with shape (1,)."""
    return np.ascontiguousarray(value).reshape(value.shape)


def _map_leaf(collection: str, path: Tuple[str, ...], value: np.ndarray
              ) -> Tuple[str, np.ndarray]:
    *scopes, leaf = path
    if collection == "batch_stats":
        name = _STATS.get(leaf, leaf)
    elif leaf == "kernel" and scopes[-1:] == ["deconv"]:
        if value.ndim != 4:
            raise ValueError(f"kernel {'/'.join(path)} has rank {value.ndim}")
        # ConvTranspose HWIO, unflipped -> conv_transpose2d [in, out, kh, kw]
        name, value = "weight", value[::-1, ::-1].transpose(2, 3, 0, 1)
    elif leaf == "kernel":
        name = "weight"
        if value.ndim == 2:  # Dense [in, out] -> [out, in]
            value = value.T
        elif value.ndim == 4:  # Conv HWIO -> OIHW
            value = value.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel {'/'.join(path)} has rank {value.ndim}")
    elif leaf == "scale":
        name = "weight"
    else:
        name = leaf
    return ".".join([*scopes, name]), value


def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Fills every parameter and buffer of ``model`` from ``variables``."""
    state = model.state_dict()
    filled = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise KeyError(f"unknown Flax collection '{collection}'")
        for path, value in _leaves(tree):
            key, value = _map_leaf(collection, path, value)
            where = f"{collection}/{'/'.join(path)}"
            if key not in state:
                raise KeyError(f"Flax leaf {where} -> '{key}' has no "
                               f"counterpart in {type(model).__name__}")
            if key in filled:
                raise KeyError(f"Flax leaf {where} fills '{key}' twice")
            if tuple(value.shape) != tuple(state[key].shape):
                raise ValueError(f"Flax leaf {where} {value.shape} does not "
                                 f"fit '{key}' {tuple(state[key].shape)}")
            filled[key] = torch.from_numpy(_contiguous(value)).to(
                state[key].dtype)
    missing = sorted(set(state) - set(filled))
    if missing:
        raise KeyError(f"{len(missing)} entries of {type(model).__name__} "
                       f"have no Flax leaf: {missing[:8]}")
    model.load_state_dict(filled, strict=True)


_STAT_LEAVES = {v: k for k, v in _STATS.items()}


def to_flax_layout(model: nn.Module, tensors: Mapping[str, torch.Tensor]
                   ) -> Dict[str, Dict]:
    """``{port name: tensor}`` -> ``{"params": tree, "batch_stats": tree}``
    in Flax's layout (float32 numpy leaves), for the names present. Raises
    on a name that is not in ``model.state_dict()``."""
    state = model.state_dict()
    out: Dict[str, Dict] = {}
    for key, tensor in tensors.items():
        if key not in state:
            raise KeyError(f"'{key}' is not an entry of "
                           f"{type(model).__name__}")
        *scopes, name = key.split(".")
        value = tensor.detach().float().cpu().numpy()
        collection = "params"
        if name in _STAT_LEAVES:
            collection, leaf = "batch_stats", _STAT_LEAVES[name]
        elif name == "weight" and scopes[-1:] == ["deconv"]:
            # conv_transpose2d [in, out, kh, kw] -> HWIO, unflipped
            leaf, value = "kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif name == "weight" and value.ndim == 2:  # Linear -> Dense kernel
            leaf, value = "kernel", value.T
        elif name == "weight" and value.ndim == 4:  # OIHW -> HWIO
            leaf, value = "kernel", value.transpose(2, 3, 1, 0)
        elif name == "weight":  # BatchNorm / LayerNorm
            leaf = "scale"
        else:
            leaf = name
        node = out.setdefault(collection, {})
        for scope in scopes:
            node = node.setdefault(scope, {})
        node[leaf] = _contiguous(value)
    return out
