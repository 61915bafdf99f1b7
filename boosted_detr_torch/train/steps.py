"""Train, eval and predict steps.

Counterpart of boosted_detr_tpu/train/steps.py:25-339: ``TrainState``, the
per-tensor ``clip_by_per_variable_norm``, ``make_optimizer`` (SGD with
Nesterov momentum, or AdamW, with the learning rate set each step from the
schedule, behind the adaptive gradient clip of ``agc_clip`` and the
per-tensor clipnorm), ``targets_from_batch``, ``compute_losses`` (with the
L-block fold), ``make_update_step`` (with EMA), ``resolve_loss_weights``,
``make_train_step``, ``make_eval_step``, ``make_predict_step`` and the
serving entry point ``predict`` (with early exit); ``seeded_step``, the
wrapper the panoptic and pre-training steps share with the train step
(the state check and the step's dropout generator); ``with_ema_params``; and
staged training: ``boosted_block_mask``, ``apply_trainable_mask``, the
``trainable_mask`` of ``make_optimizer`` and ``TrainConfig.train_block``.

Across processes (``TrainConfig.mesh_shape``, or every rank of the process
group on 'data' without one; parallel/mesh.py) a step computes what one
process computes on the global batch, as JAX's pjit does: its batch is
this rank's rows, its forward and loss run under the mesh (BatchNorm's
statistics, the loss normalisers and the random draws are the global
batch's), the gradients are summed over the 'data' group before the
optimizer (the loss is a global sum, so a sum and not DDP's mean), the
clips of tensor-parallel leaves take their norms over the 'model' group,
and the returned losses and metrics are the global batch's. Every rank
then holds the same parameters bit for bit.

Staged freezing is optax's ``multi_transform`` with ``set_to_zero``
(steps.py:129-136) in torch terms: the optimizer holds only the trained
leaves, so the frozen ones get no update, no momentum, no weight decay and
no clip, and stay bit for bit the same; and a train step computes
gradients only for the leaves its optimizer holds (the others are set to
``requires_grad=False`` for the step and put back after it), so a staged
step does no backward work for a frozen backbone, as XLA drops that work.
BatchNorm running statistics of frozen modules still update in train mode,
as Flax's mutable ``batch_stats`` do.

JAX's steps are pure functions of a state; here the state holds the model
and the optimizer, and a train step updates them in place. Every step sets
the mode it needs (``train()`` or ``eval()``) on each call, and the predict
step puts back the mode it found, so that a prediction between two train
steps changes nothing. Nothing on a step reads a value back from the card:
the step count is a host integer, the learning rate is computed on the host
from it, and the losses stay tensors until the caller fetches them. The
parts of a train step carry ``torch.profiler`` ranges (``train_step/
forward``, ``loss_and_matching``, ``backward``, ``optimizer``), which cost a
few microseconds a step when no profiler runs.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import inspect
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from boosted_detr_torch.config import LossWeights, ModelConfig, TrainConfig
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.models import early_exit
from boosted_detr_torch.ops import matching
from boosted_detr_torch.parallel import mesh as mesh_lib
from boosted_detr_torch.train import schedules

@dataclasses.dataclass
class TrainState:
    """The step count (a host integer), the model, its optimizer and, when
    EMA is on, a float32 shadow copy of the parameters by name."""

    step: int
    model: nn.Module
    optimizer: "Optimizer"
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: "Optimizer",
               ema: bool = False) -> "TrainState":
        shadow = ({k: p.detach().clone() for k, p in model.named_parameters()}
                  if ema else None)
        return cls(step=0, model=model, optimizer=optimizer,
                   ema_params=shadow)


def with_ema_params(state: TrainState) -> TrainState:
    """A state whose model is a copy of ``state.model`` holding the EMA
    weights (for eval or export); ``state`` is left as it is, and a train
    step made for its model refuses the copy. Raises if the state was
    created without EMA."""
    if state.ema_params is None:
        raise ValueError("this TrainState has no EMA shadow; set "
                         "TrainConfig.ema_decay > 0 before compile()")
    model = copy.deepcopy(state.model)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return dataclasses.replace(state, model=model)


def clip_by_per_variable_norm(grads: List[torch.Tensor],
                              max_norm: float, splits=None) -> None:
    """Keras ``clipnorm``: scales EACH gradient tensor in place by
    ``min(1, max_norm / max(||g||, 1e-12))``, its own L2 norm in float32
    (not the global norm that ``clip_grad_norm_`` clips). ``splits``
    gives each gradient's ``tp_split`` ((dim, group) of a tensor-parallel
    slice, or None): the squared norms of slices are summed over their
    group first, since JAX clips the whole tensor."""
    if not grads:
        return
    norms = list(torch._foreach_norm([g.float() for g in grads]))
    split = [i for i, s in enumerate(splits or ()) if s is not None]
    if split:
        whole = mesh_lib.reduce_sum(torch.stack(
            [norms[i].square() for i in split]), splits[split[0]][1]).sqrt()
        for j, i in enumerate(split):
            norms[i] = whole[j]
    for g, norm in zip(grads, norms):
        scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
        g.mul_(scale.to(g.dtype))


def unitwise_dims(name: str, p: torch.Tensor) -> Optional[Tuple[int, ...]]:
    """The dims over which optax's ``unitwise_norm`` sums for the leaf
    ``name``, in the port's layout, or None where the AGC mask leaves it
    alone (a leaf whose Flax ndim is below 2: ``skip_gain``, biases, norm
    scales and gains; steps.py:88-99).

    Trap: optax works in Flax's layout. A Dense kernel [in, out] sums over
    axis 0 (in), an HWIO conv kernel over (0, 1, 2), any other 2-D leaf (a
    [T, D] embedding) over axis 0, and a leaf with at most one axis longer
    than 1 over all of it. So the port's Linear weight [out, in] sums over
    dim 1 and its OIHW conv weight over (1, 2, 3), while an embedding, in
    the same layout on both sides, sums over dim 0."""
    if p.dim() < 2:
        return None
    if p.squeeze().dim() <= 1:
        return tuple(range(p.dim()))
    weight = name.split(".")[-1] == "weight"  # a transposed Flax kernel
    if p.dim() == 2:
        return (1,) if weight else (0,)
    if p.dim() == 4 and weight:
        return (1, 2, 3)
    raise ValueError(f"no unit-wise norm for {name} {tuple(p.shape)}")


def adaptive_grad_clip(units: List[Tuple[torch.Tensor, Tuple[int, ...]]],
                       clip: float) -> None:
    """optax ``adaptive_grad_clip(clip)`` (NFNet AGC) in place on each
    parameter's gradient: per unit, where ``||g|| >= max_norm = clip *
    max(||p||, 1e-3)``, ``g * max_norm / max(||g||, 1e-6)``; ``units`` pairs
    each parameter with its ``unitwise_dims``. Norms in float32; a
    tensor-parallel slice split along a summed dim sums its squares over
    its group first."""
    for p, dims in units:
        g = p.grad
        if g is None:
            continue
        squares = torch.stack([g.float().square().sum(dims, keepdim=True),
                               p.detach().float().square().sum(
                                   dims, keepdim=True)])
        split = getattr(p, "tp_split", None)
        if split is not None and split[0] in dims:
            squares = mesh_lib.reduce_sum(squares, split[1])
        g_norm, p_norm = squares.sqrt()
        max_norm = clip * p_norm.clamp_min(1e-3)
        clipped = g * (max_norm / g_norm.clamp_min(1e-6))
        g.copy_(torch.where(g_norm < max_norm, g, clipped))


@dataclasses.dataclass
class Optimizer:
    """The JAX package's optax chain: the adaptive gradient clip on the
    ``agc`` units when ``agc_clip`` is set, per-tensor clipnorm, then SGD
    with Nesterov momentum (``dampening=0``, the same trace as optax's) or
    AdamW with optax's defaults; the learning rate is ``schedule(count)``
    with ``count`` from 0, as optax counts."""

    inner: torch.optim.Optimizer
    schedule: Callable[[int], float]
    clipnorm: float
    count: int = 0
    agc_clip: float = 0.0
    agc: Tuple[Tuple[torch.Tensor, Tuple[int, ...]], ...] = ()

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.inner.param_groups for p in group["params"]]

    def step(self) -> None:
        if self.agc_clip:
            held = {id(p) for p in self.params}
            adaptive_grad_clip([u for u in self.agc if id(u[0]) in held],
                               self.agc_clip)
        if self.clipnorm:
            held = [p for p in self.params if p.grad is not None]
            grads = [p.grad for p in held]
            splits = [getattr(p, "tp_split", None) for p in held]
            if any(splits):
                clip_by_per_variable_norm(grads, self.clipnorm, splits)
            else:  # the two-argument call that the tests' spies wrap
                clip_by_per_variable_norm(grads, self.clipnorm)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


NamedParams = Iterable[Tuple[str, torch.Tensor]]


def _masked(params, trainable_mask: Optional[Mapping[str, bool]]
            ) -> List[torch.Tensor]:
    """The tensors of ``params``; with a mask, ``params`` are (name, tensor)
    pairs, as ``named_parameters()`` gives them, and only those the mask
    marks True are kept."""
    params = list(params)
    if trainable_mask is None:
        return [p[1] if isinstance(p, tuple) else p for p in params]
    if not all(isinstance(p, tuple) for p in params):
        raise ValueError("a trainable_mask needs named parameters: pass "
                         "model.named_parameters()")
    names = [name for name, _ in params]
    odd = sorted(set(names) ^ set(trainable_mask))
    if odd:
        raise KeyError("the trainable_mask and the parameters name "
                       f"different leaves: {odd[:8]}")
    return [p for name, p in params if trainable_mask[name]]


def make_optimizer(cfg: TrainConfig, params, d_model: int = 256,
                   trainable_mask: Optional[Mapping[str, bool]] = None
                   ) -> Optimizer:
    """SGD(momentum, Nesterov) or AdamW over ``params``, behind per-tensor
    clipnorm and the learning-rate schedule. ``trainable_mask`` ({name:
    bool}, e.g. ``boosted_block_mask``; ``params`` then are
    ``model.named_parameters()``) is staged freezing: the optimizer holds
    the leaves marked True only. ``cfg.agc_clip > 0`` puts the adaptive
    gradient clip first in the chain, on the leaves of Flax ndim >= 2
    (``unitwise_dims``); it reads each leaf's layout from its name, so
    ``params`` then are ``model.named_parameters()`` too."""
    schedule = schedules.make_schedule(cfg.lr_schedule, cfg.learning_rate,
                                       cfg.warmup_steps, d_model)
    params = list(params)
    agc = ()
    if cfg.agc_clip:
        if not all(isinstance(p, tuple) for p in params):
            raise ValueError("agc_clip reads each leaf's layout from its "
                             "name: pass model.named_parameters()")
        agc = tuple((p, dims) for name, p in params
                    if (dims := unitwise_dims(name, p)) is not None)
    params = _masked(params, trainable_mask)
    if cfg.optimizer == "sgd":
        inner = torch.optim.SGD(params, lr=cfg.learning_rate,
                                momentum=cfg.momentum, dampening=0.0,
                                nesterov=cfg.nesterov)
    elif cfg.optimizer == "adamw":
        inner = torch.optim.AdamW(params, lr=cfg.learning_rate,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=cfg.weight_decay)
    else:
        raise ValueError(f"unknown optimizer '{cfg.optimizer}'")
    return Optimizer(inner, schedule, cfg.clipnorm, agc_clip=cfg.agc_clip,
                     agc=agc)


def boosted_block_mask(model: nn.Module, k: int) -> Dict[str, bool]:
    """Staged boosting's trainable mask, {parameter name: bool}: only weak
    learner k's leaves (``encoder_k``, ``decoder_block_k``, ``*_head_k``)
    and the shared ``decoder_prep`` queries train; everything else,
    backbone included, freezes (steps.py:113-126). Decided by top-level
    scope."""
    wanted = {f"encoder_{k}", f"decoder_block_{k}", f"category_head_{k}",
              f"attribute_head_{k}", f"box_head_{k}", "decoder_prep"}
    return {name: name.split(".")[0] in wanted
            for name, _ in model.named_parameters()}


def apply_trainable_mask(optimizer: Optimizer, params: NamedParams,
                         trainable_mask: Mapping[str, bool]) -> Optimizer:
    """``optimizer`` (any torch optimizer inside) rebuilt over the leaves
    of ``params`` that ``trainable_mask`` marks True, with a fresh state
    and its settings, schedule, clip and count: the leaves marked False get
    no update (steps.py:129-136)."""
    cls = type(optimizer.inner)
    accepted = inspect.signature(cls).parameters
    inner = cls(_masked(params, trainable_mask),
                **{k: v for k, v in optimizer.inner.defaults.items()
                   if k in accepted})
    return dataclasses.replace(optimizer, inner=inner)


def targets_from_batch(batch: Dict[str, torch.Tensor], num_categories: int,
                       num_attributes: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Integer ids to one-hot categories [B, O, Vc] and multi-hot
    attributes [B, O, Va] (a max over the padded attribute-word axis),
    float32. An id outside the vocabulary gives a zero row, as
    ``jax.nn.one_hot`` does."""

    def one_hot(ids, n):
        ids = ids.long()
        return (ids[..., None] == torch.arange(n, device=ids.device)).float()

    category = one_hot(batch["category_ids"], num_categories)
    attribute = one_hot(batch["attribute_ids"], num_attributes).amax(dim=-2)
    return category, attribute


def compute_losses(preds_list, batch, cfg: ModelConfig, weights: LossWeights,
                   fold: bool = True) -> Tuple[torch.Tensor, Dict]:
    """The matched loss summed over the prediction blocks (one entry: the
    final block only). With L > 1 blocks the L problems are folded into one
    [L*B, O, P] ``matching_loss`` call, one matcher launch, and the
    per-block normalisation ``1 + sum(n)`` is restored by the rescale
    ``(1 + L sum(n)) / (1 + sum(n))`` (the exist term needs none);
    ``fold=False`` is the sequential loop. Returns (the scalar loss summed
    over the batch, aux: ``loss_*`` sums and the mean matched IoU)."""
    category, attribute = targets_from_batch(batch, cfg.num_categories,
                                             cfg.num_attributes)
    bbox = batch["bbox"].float()
    num_objects = batch["num_objects"]
    n_blocks = len(preds_list)
    if fold and n_blocks > 1:
        b = bbox.shape[0]

        def tile(x):
            return torch.cat([x] * n_blocks, dim=0)

        stacked = {k: torch.cat([p[k] for p in preds_list], dim=0)
                   for k in ("category", "attribute", "boxes")}
        losses, mets = matching.matching_loss(
            tile(category), tile(attribute), tile(bbox), tile(num_objects),
            stacked["category"], stacked["attribute"], stacked["boxes"],
            weights=weights, matcher=cfg.matcher)
        sum_n = mesh_lib.data_sum(num_objects)
        rescale = (1.0 + n_blocks * sum_n) / (1.0 + sum_n)
        acc = {k: v.reshape(n_blocks, b).sum(dim=0)
               for k, v in losses.items()}
        for k in ("category", "attribute", "box"):
            acc[k] = acc[k] * rescale
        acc["total"] = (acc["category"] + acc["attribute"] + acc["box"]
                        + acc["exist"])
        metrics = {"iou": mets["iou"].reshape(n_blocks, b)[-1] * rescale}
    else:
        acc, metrics = None, {}
        for preds in preds_list:
            losses, metrics = matching.matching_loss(
                category, attribute, bbox, num_objects, preds["category"],
                preds["attribute"], preds["boxes"], weights=weights,
                matcher=cfg.matcher)
            acc = losses if acc is None else {k: acc[k] + losses[k]
                                              for k in losses}
    scalar = acc["total"].sum()
    aux = {f"loss_{k}": v.sum() for k, v in acc.items()}
    aux["iou"] = metrics["iou"].mean()
    return scalar, aux


def resolve_loss_weights(model_cfg: ModelConfig,
                         train_cfg: TrainConfig) -> LossWeights:
    """``classification_only`` zeroes the box weight."""
    weights = train_cfg.loss_weights
    if model_cfg.classification_only:
        weights = dataclasses.replace(weights, box=0.0)
    return weights


def make_update_step(loss_fn: Callable, ema_decay: float = 0.0,
                     mesh: Optional[mesh_lib.Mesh] = None) -> Callable:
    """Wraps ``loss_fn(model, batch, generator) -> (loss, aux)`` into the
    update step: backward, optimizer (clip, schedule, update), and the EMA
    shadow ``e = d e + (1 - d) p`` when the state carries one. The step's
    ``generator`` (the dropout bits) is handed to ``loss_fn``. Under a
    ``mesh`` of several ranks the loss and its backward run inside it, the
    gradients are summed over its 'data' group (``train_step/all_reduce``)
    and the returned losses and metrics are global. Raises
    ``ValueError`` when a parameter was split by ``shard_module`` over
    another 'model' group than the mesh's."""
    data = mesh_lib.axis_of(mesh_lib.DATA_AXIS, mesh) if mesh else None
    checked = []  # the optimizer whose parameters were held to the mesh

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        if not checked or checked[0] is not state.optimizer:
            check_tensor_split(state.optimizer.params, mesh)
            checked[:] = [state.optimizer]
        state.model.zero_grad(set_to_none=True)
        # gradients for the leaves the optimizer trains only (staged
        # freezing); the flags are put back after the backward
        trained = {id(p) for p in state.optimizer.params}
        frozen = [p for p in state.model.parameters()
                  if p.requires_grad and id(p) not in trained]
        for p in frozen:
            p.requires_grad_(False)
        try:
            with _within(mesh):
                loss, aux = loss_fn(state.model, batch, generator)
                with record_function("train_step/backward"):
                    loss.backward()
        finally:
            for p in frozen:
                p.requires_grad_(True)
        if data is not None:
            with record_function("train_step/all_reduce"):
                mesh_lib.all_reduce_gradients(state.optimizer.params,
                                              data[2])
        with record_function("train_step/optimizer"):
            state.optimizer.step()
        if state.ema_params is not None and ema_decay > 0.0:
            with torch.no_grad(), record_function("train_step/ema"):
                for name, p in state.model.named_parameters():
                    e = state.ema_params[name]
                    e.copy_(e * ema_decay + p.to(e.dtype) * (1.0 - ema_decay))
        state.step += 1
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = loss.detach()
        return state, mesh_lib.global_metrics(aux, mesh)

    return train_step


def check_tensor_split(params: Iterable[torch.Tensor],
                       mesh: Optional[mesh_lib.Mesh]) -> None:
    """Raises ``ValueError`` unless every parameter that ``shard_module``
    split (``p.tp_split``) is split over ``mesh``'s 'model' group: under
    any other mesh the data all-reduce would sum different slices of it."""
    model = mesh_lib.axis_of(mesh_lib.MODEL_AXIS, mesh) if mesh else None
    for p in params:
        split = getattr(p, "tp_split", None)
        if split is not None and (model is None or split[1] is not model[2]):
            raise ValueError(
                "a parameter is split over a 'model' group that is not this "
                "step's mesh's; train with the mesh_shape it was sharded "
                "with")


def _within(mesh: Optional[mesh_lib.Mesh]):
    """``mesh`` as the active mesh, or nothing."""
    return mesh if mesh is not None else contextlib.nullcontext()


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def set_mode(model: nn.Module, training: bool) -> None:
    """``model.train(training)`` when the root module is in the other mode:
    the walk over every submodule costs ~0.7 ms of host time at the
    flagship, which a host-bound step would pay on every call."""
    if model.training != training:
        model.train(training)


def check_state(state: TrainState, model: nn.Module) -> None:
    if state.model is not model:
        raise ValueError("the state holds another model than the one this "
                         "step was made for")


def make_train_step(model: nn.Module, model_cfg: ModelConfig,
                    train_cfg: TrainConfig) -> Callable:
    """The train step of a DETR: ``train_step(state, batch, generator=None)
    -> (state, aux)``. ``batch`` holds ``image`` [B, H, W, 3] float32 in
    [0, 1], ``category_ids`` [B, O], ``attribute_ids`` [B, O, W],
    ``bbox`` [B, O, 4] COCO and ``num_objects`` [B], on the model's device.
    Without a generator, the dropout bits of step ``s`` come from a
    generator seeded with ``(train_cfg.seed, s)``, as JAX folds the step
    into its key.

    ``train_cfg.train_block = k`` with intermediate losses takes the loss
    of block ``min(k, n - 1)`` alone, and a ``BoostedDETR`` without a
    focused layer runs its forward only up to that block
    (steps.py:264-275, :295-298). Without intermediate losses it changes
    nothing here. Which leaves train is the optimizer's: staged training
    builds it with ``trainable_mask=boosted_block_mask(model, k)``.

    ``train_cfg.mesh_shape`` (every rank on 'data' when None) is the mesh
    of the step (``make_mesh``, which raises when it does not match the
    process group): the batch is then this rank's rows of the global
    batch, and the step computes the global batch's step (see the
    module's docstring)."""
    mesh = mesh_lib.make_mesh(train_cfg.mesh_shape, device=_device_of(model))
    weights = resolve_loss_weights(model_cfg, train_cfg)
    intermediate = train_cfg.use_intermediate_losses
    loss_block = train_cfg.train_block if intermediate else None
    focus = None
    if (loss_block is not None  # a BoostedDETR with no focused layer
            and getattr(model, "focused_training_layer", False) is None):
        # later blocks are downstream of block k: the same gradients from
        # a forward that stops at k
        focus = min(loss_block, model.config.num_decoder_blocks - 1)

    def forward(model, image, **kw):
        if focus is None:
            return model(image, return_intermediate=intermediate, **kw)
        with model.focused(focus):
            return model(image, return_intermediate=intermediate, **kw)

    def loss_fn(model, batch, generator):
        with record_function("train_step/forward"):
            if train_cfg.freeze_bn_stats:
                # running statistics, no dropout: the JAX train=False forward
                set_mode(model, False)
                outs = forward(model, batch["image"])
            else:
                set_mode(model, True)
                outs = forward(model, batch["image"], generator=generator)
        preds_list = outs if intermediate else [outs]
        if loss_block is not None:
            # the focused block's cumulative loss alone; a focused model's
            # list holds that block only
            preds_list = [preds_list[min(loss_block, len(preds_list) - 1)]]
        with record_function("train_step/loss_and_matching"):
            loss, aux = compute_losses(preds_list, batch, model_cfg, weights)
        if (intermediate and train_cfg.intermediate_loss_avg
                and len(preds_list) > 1):
            scale = 1.0 / len(preds_list)
            loss = loss * scale
            aux = {k: (v * scale if k.startswith("loss_") else v)
                   for k, v in aux.items()}
        return loss, aux

    return seeded_step(model, train_cfg.seed, make_update_step(
        loss_fn, ema_decay=train_cfg.ema_decay, mesh=mesh))


def seeded_step(model: nn.Module, seed: int, update: Callable) -> Callable:
    """``update`` (from ``make_update_step``) as the step of ``model``:
    ``train_step(state, batch, generator=None)`` refuses a state holding
    another model, and without a generator draws the dropout bits of step
    ``s`` from a generator seeded with ``(seed, s)``, as JAX folds the step
    into its key."""

    def train_step(state: TrainState, batch, generator=None):
        check_state(state, model)
        if generator is None:
            generator = torch.Generator(device=_device_of(state.model))
            generator.manual_seed(int(np.random.SeedSequence(
                [seed, state.step]).generate_state(1)[0]))
        return update(state, batch, generator)

    return train_step


def make_eval_step(model: nn.Module, model_cfg: ModelConfig,
                   train_cfg: TrainConfig) -> Callable:
    """Validation: the training loss at ``train=False``, no update; across
    processes, the global batch's losses (the batch is this rank's
    rows)."""
    weights = resolve_loss_weights(model_cfg, train_cfg)
    mesh = mesh_lib.make_mesh(train_cfg.mesh_shape, device=_device_of(model))

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        check_state(state, model)
        set_mode(model, False)
        with torch.no_grad(), mesh:
            outs = state.model(batch["image"])
            loss, aux = compute_losses([outs], batch, model_cfg, weights)
            aux["loss"] = loss
            return mesh_lib.global_metrics(aux, mesh)

    return eval_step


def make_predict_step(model: nn.Module,
                      return_intermediate: bool = False) -> Callable:
    """Inference forward (the JAX ``train=False``): a function from an
    image tensor on the model's device to the raw probability/box tensors
    (every block's with ``return_intermediate``). It runs ``model`` in eval
    mode and puts back the mode it found."""

    def predict_step(image: torch.Tensor):
        was_training = model.training
        set_mode(model, False)
        try:
            with torch.inference_mode():
                return model(image, return_intermediate=return_intermediate)
        finally:
            set_mode(model, was_training)

    return predict_step


def predict(model: nn.Module, images: np.ndarray,
            codec: Optional[TextCodec] = None, decode_text: bool = True,
            early_exit_threshold: Optional[float] = None):
    """Images [B, H, W, 3] in [0, 1] (numpy, or a tensor on any device)
    -> (category_strings,
    attribute_strings, boxes) through ``codec``, or the raw probability dict
    of numpy arrays when ``decode_text`` is False or there is no codec.

    ``early_exit_threshold`` (``model.config.early_exit_threshold`` when
    None) is adaptive-depth inference, as the JAX trainer's ``predict``
    (trainer.py:427-470): the full forward with every block's output, then
    per image the earliest block that meets
    ``model.config.early_exit_criterion`` (``stability_select`` or
    ``adaptive_select``, models/early_exit.py), with the category output
    renormalized; the raw dict then holds ``exit_block`` [B] too."""
    device = _device_of(model)
    if isinstance(images, torch.Tensor):
        image = images.to(device, torch.float32)
    else:
        image = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    threshold = (early_exit_threshold if early_exit_threshold is not None
                 else model.config.early_exit_threshold)
    if threshold is None:
        preds = make_predict_step(model)(image)
    else:
        select = (early_exit.stability_select
                  if model.config.early_exit_criterion == "stability"
                  else early_exit.adaptive_select)
        outs = make_predict_step(model, return_intermediate=True)(image)
        with torch.inference_mode():
            preds, exit_block = select(outs, threshold)
        preds = dict(preds, exit_block=exit_block)
    preds = {k: v.cpu().numpy() for k, v in preds.items()}
    if decode_text and codec is not None:
        return codec.decode_predictions(preds)
    return preds
