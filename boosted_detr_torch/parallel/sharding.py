"""Parameter sharding rules: Megatron-style tensor parallelism over the
'model' mesh axis.

Counterpart of boosted_detr_tpu/parallel/sharding.py. The attention's
query, key and value projections and the FFN's first Dense are
column-split (output features over 'model'), the attention's output
projection and the FFN's second Dense row-split (input features over
'model', the bias added once after the sum); everything else is
replicated. The names are Flax's, which the port's parameters keep.

Under GSPMD a rule is a placement and XLA inserts whatever collective it
implies, so JAX may split any leaf alone. Here ``shard_module`` computes
the split by hand: each rank keeps its rows of a column-split weight (a
``Dense`` stores torch's [out, in]) and its columns of a row-split one,
and the layer pair needs one sum: ``mesh.sum_backward`` (identity
forward, sum backward) before the column-split layers and
``mesh.sum_forward`` (sum forward, identity backward) after the row-split
one. The MHA keeps ``num_heads / model`` heads. A pair splits only whole:
where either member cannot split evenly, or the heads do not divide by
'model', the pair stays replicated, and the values are still JAX's.
Column-split leaves with no row-split partner (the panoptic attention
maps' projections) stay replicated for the same reason.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch
from torch import nn

from boosted_detr_torch.models import layers
from boosted_detr_torch.parallel.mesh import MODEL_AXIS, Mesh

Spec = Tuple  # per tensor dim: MODEL_AXIS or None; () is replicated

# parameter-owner names -> how their Dense splits
_COLUMN_SPLIT = ("query_projection", "key_projection", "value_projection",
                 "dense_relu")
_ROW_SPLIT = ("output_projection", "dense_linear")


def _spec_for(name: str) -> Spec:
    """The split of the parameter ``name`` by its owner, in the port's
    layout: a column-split weight [out, in] over dim 0 and its bias, a
    row-split weight over dim 1 (its bias replicated)."""
    keys = name.split(".")
    if len(keys) >= 2 and keys[-1] == "weight":
        if keys[-2] in _COLUMN_SPLIT:
            return (MODEL_AXIS, None)
        if keys[-2] in _ROW_SPLIT:
            return (None, MODEL_AXIS)
    if len(keys) >= 2 and keys[-1] == "bias" and keys[-2] in _COLUMN_SPLIT:
        return (MODEL_AXIS,)
    return ()


def _divides(spec: Spec, p: torch.Tensor, n: int) -> bool:
    return all(axis is None or dim % n == 0
               for axis, dim in zip(spec, p.shape))


def _pairs(model: nn.Module) -> Iterator[Tuple[str, nn.Module, List[str]]]:
    """Each module whose Dense layers split as one pair: (its name, it,
    the names of its Dense layers)."""
    for name, module in model.named_modules():
        if isinstance(module, layers.MultiheadAttention):
            yield name, module, ["query_projection", "key_projection",
                                 "value_projection", "output_projection"]
        elif isinstance(module, layers.FeedForwardBlock):
            yield name, module, ["dense_relu", "dense_linear"]


def param_shardings(model: nn.Module, mesh: Mesh) -> Dict[str, Spec]:
    """{parameter name: spec} of the rules above, as ``shard_module``
    applies them: a leaf whose split axis does not divide by 'model' is
    replicated (JAX's guard), and so is the rest of its pair."""
    n = mesh.shape[MODEL_AXIS]
    params = dict(model.named_parameters())
    specs = {name: (_spec_for(name) if _divides(_spec_for(name), p, n)
                    else ()) for name, p in params.items()}
    paired = set()
    for prefix, module, denses in _pairs(model):
        names = [f"{prefix}.{d}.{leaf}" if prefix else f"{d}.{leaf}"
                 for d in denses for leaf in ("weight", "bias")]
        paired.update(names)
        whole = all(specs[k] == _spec_for(k) for k in names) and (
            not isinstance(module, layers.MultiheadAttention)
            or module.num_heads % n == 0)
        if not whole:
            specs.update(dict.fromkeys(names, ()))
    # a split leaf outside a pair has no partner to sum it
    return {k: (v if k in paired else ()) for k, v in specs.items()}


def state_shardings(state, mesh: Mesh) -> Dict[str, Dict]:
    """The shardings of a whole ``TrainState``: the parameters', the
    optimizer's per-parameter tensors (momentum, moments) following their
    parameter, the EMA shadow following the parameters; the rest (step
    counts) replicated."""
    specs = param_shardings(state.model, mesh)
    names = {id(p): k for k, p in state.model.named_parameters()}
    opt = {}
    for p, entries in state.optimizer.inner.state.items():
        name = names[id(p)]
        opt[name] = {k: (specs[name] if isinstance(v, torch.Tensor)
                         and v.shape == p.shape else ())
                     for k, v in entries.items()}
    out = {"params": specs, "opt_state": opt}
    if state.ema_params is not None:
        out["ema_params"] = {k: specs[k] for k in state.ema_params}
    return out


def shard_module(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Applies ``param_shardings`` to ``model`` in place: each split
    parameter keeps this rank's slice (the same ``Parameter`` object, so
    an optimizer built afterwards holds the slices), each split Dense
    sums over the mesh's 'model' group as its side of the pair needs, and
    each split MHA keeps its local heads. Build the optimizer after this.
    Returns ``model``."""
    n = mesh.shape[MODEL_AXIS]
    if n == 1:
        return model
    index, group = mesh.coords[MODEL_AXIS], mesh.groups[MODEL_AXIS]
    specs = param_shardings(model, mesh)
    for prefix, module, denses in _pairs(model):
        key = f"{prefix}.{denses[0]}.weight" if prefix \
            else f"{denses[0]}.weight"
        if not specs[key]:
            continue
        for d in denses:
            dense = getattr(module, d)
            dim = 1 if d in _ROW_SPLIT else 0
            with torch.no_grad():
                for leaf in ("weight", "bias"):
                    p = getattr(dense, leaf)
                    if leaf == "bias" and dim == 1:
                        continue
                    size = p.shape[dim] // n
                    p.data = p.data.narrow(dim, index * size, size).clone()
                    p.tp_split = (dim, group)
            dense.tp_split = ("row" if dim else "column", group)
        if isinstance(module, layers.MultiheadAttention):
            module.num_heads //= n
    return model
