"""Train, eval and predict steps.

Counterpart of boosted_detr_tpu/train/steps.py:25-339: ``TrainState``, the
per-tensor ``clip_by_per_variable_norm``, ``make_optimizer`` (SGD with
Nesterov momentum, or AdamW, with the learning rate set each step from the
schedule), ``targets_from_batch``, ``compute_losses`` (with the L-block
fold), ``make_update_step`` (with EMA), ``resolve_loss_weights``,
``make_train_step``, ``make_eval_step``, ``make_predict_step`` and the
serving entry point ``predict``.

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

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from boosted_detr_torch.config import LossWeights, ModelConfig, TrainConfig
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.ops import matching
from boosted_detr_torch.train import schedules

_LATER = "TrainConfig.{} is not ported yet (ROADMAP.md, Queue 1: {})"


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


def clip_by_per_variable_norm(grads: List[torch.Tensor],
                              max_norm: float) -> None:
    """Keras ``clipnorm``: scales EACH gradient tensor in place by
    ``min(1, max_norm / max(||g||, 1e-12))``, its own L2 norm in float32
    (not the global norm that ``clip_grad_norm_`` clips)."""
    if not grads:
        return
    norms = torch._foreach_norm([g.float() for g in grads])
    for g, norm in zip(grads, norms):
        scale = torch.clamp(max_norm / norm.clamp_min(1e-12), max=1.0)
        g.mul_(scale.to(g.dtype))


@dataclasses.dataclass
class Optimizer:
    """The JAX package's optax chain: per-tensor clipnorm, then SGD with
    Nesterov momentum (``dampening=0``, the same trace as optax's) or AdamW
    with optax's defaults; the learning rate is ``schedule(count)`` with
    ``count`` from 0, as optax counts."""

    inner: torch.optim.Optimizer
    schedule: Callable[[int], float]
    clipnorm: float
    count: int = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for group in self.inner.param_groups for p in group["params"]]

    def step(self) -> None:
        if self.clipnorm:
            clip_by_per_variable_norm(
                [p.grad for p in self.params if p.grad is not None],
                self.clipnorm)
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)


def make_optimizer(cfg: TrainConfig, params, d_model: int = 256
                   ) -> Optimizer:
    """SGD(momentum, Nesterov) or AdamW over ``params``, behind per-tensor
    clipnorm and the learning-rate schedule."""
    if cfg.agc_clip:
        raise NotImplementedError(_LATER.format(
            "agc_clip", "the other backbones, skipinit"))
    schedule = schedules.make_schedule(cfg.lr_schedule, cfg.learning_rate,
                                       cfg.warmup_steps, d_model)
    params = list(params)
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
    return Optimizer(inner, schedule, cfg.clipnorm)


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
        sum_n = num_objects.sum().float()
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


def make_update_step(loss_fn: Callable, ema_decay: float = 0.0) -> Callable:
    """Wraps ``loss_fn(model, batch, generator) -> (loss, aux)`` into the
    update step: backward, optimizer (clip, schedule, update), and the EMA
    shadow ``e = d e + (1 - d) p`` when the state carries one. The step's
    ``generator`` (the dropout bits) is handed to ``loss_fn``."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None):
        state.optimizer.zero_grad()
        loss, aux = loss_fn(state.model, batch, generator)
        with record_function("train_step/backward"):
            loss.backward()
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
        return state, aux

    return train_step


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _set_mode(model: nn.Module, training: bool) -> None:
    """``model.train(training)`` when the root module is in the other mode:
    the walk over every submodule costs ~0.7 ms of host time at the
    flagship, which a host-bound step would pay on every call."""
    if model.training != training:
        model.train(training)


def _check_state(state: TrainState, model: nn.Module) -> None:
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
    into its key."""
    if train_cfg.train_block is not None:
        raise NotImplementedError(_LATER.format(
            "train_block", "the boosted model"))
    if train_cfg.mesh_shape is not None:
        raise NotImplementedError(_LATER.format(
            "mesh_shape", "parallel/"))
    weights = resolve_loss_weights(model_cfg, train_cfg)
    intermediate = train_cfg.use_intermediate_losses

    def loss_fn(model, batch, generator):
        with record_function("train_step/forward"):
            if train_cfg.freeze_bn_stats:
                # running statistics, no dropout: the JAX train=False forward
                _set_mode(model, False)
                outs = model(batch["image"],
                             return_intermediate=intermediate)
            else:
                _set_mode(model, True)
                outs = model(batch["image"],
                             return_intermediate=intermediate,
                             generator=generator)
        preds_list = outs if intermediate else [outs]
        with record_function("train_step/loss_and_matching"):
            loss, aux = compute_losses(preds_list, batch, model_cfg, weights)
        if (intermediate and train_cfg.intermediate_loss_avg
                and len(preds_list) > 1):
            scale = 1.0 / len(preds_list)
            loss = loss * scale
            aux = {k: (v * scale if k.startswith("loss_") else v)
                   for k, v in aux.items()}
        return loss, aux

    update = make_update_step(loss_fn, ema_decay=train_cfg.ema_decay)

    def train_step(state: TrainState, batch, generator=None):
        _check_state(state, model)
        if generator is None:
            generator = torch.Generator(device=_device_of(state.model))
            generator.manual_seed(int(np.random.SeedSequence(
                [train_cfg.seed, state.step]).generate_state(1)[0]))
        return update(state, batch, generator)

    return train_step


def make_eval_step(model: nn.Module, model_cfg: ModelConfig,
                   train_cfg: TrainConfig) -> Callable:
    """Validation: the training loss at ``train=False``, no update."""
    weights = resolve_loss_weights(model_cfg, train_cfg)

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        _check_state(state, model)
        _set_mode(model, False)
        with torch.no_grad():
            outs = state.model(batch["image"])
            loss, aux = compute_losses([outs], batch, model_cfg, weights)
        aux["loss"] = loss
        return aux

    return eval_step


def make_predict_step(model: nn.Module) -> Callable:
    """Inference forward (the JAX ``train=False``): a function from an
    image tensor on the model's device to the raw probability/box tensors.
    It runs ``model`` in eval mode and puts back the mode it found."""

    def predict_step(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        was_training = model.training
        _set_mode(model, False)
        try:
            with torch.inference_mode():
                return model(image)
        finally:
            _set_mode(model, was_training)

    return predict_step


def predict(model: nn.Module, images: np.ndarray,
            codec: Optional[TextCodec] = None, decode_text: bool = True):
    """Images [B, H, W, 3] in [0, 1] -> (category_strings,
    attribute_strings, boxes) through ``codec``, or the raw probability dict
    of numpy arrays when ``decode_text`` is False or there is no codec."""
    device = _device_of(model)
    image = torch.from_numpy(np.asarray(images, np.float32)).to(device)
    preds = make_predict_step(model)(image)
    preds = {k: v.cpu().numpy() for k, v in preds.items()}
    if decode_text and codec is not None:
        return codec.decode_predictions(preds)
    return preds

