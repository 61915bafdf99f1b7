"""The classifier pre-trainer in PyTorch, sharing the DETR trunk.

Counterpart of boosted_detr_tpu/models/pretrainer.py:37-165:
``DETRMultiClassifier`` (a multi-label image classifier over a ``detr``
trunk), ``pretrain_loss``, ``make_pretrain_step``, ``transfer_to_detr`` and
``load_from_detr``.

After every decoder block the classifier head gives per-query class
probabilities; the best query per class is the image's prediction
[B, 1, C]. The loss is the sigmoid focal loss against the multi-hot of the
image's categories, summed over the classes and over the blocks; there is
no matching.

The ``detr`` child is a port ``DETR`` built with ``heads=False``: the JAX
pre-trainer never calls the detector's heads, so Flax never creates their
leaves, and a port pre-trainer that held them would carry parameters the
bridge cannot fill and the optimizer would step. ``transfer_to_detr`` and
``load_from_detr`` copy the trunk's state between a pre-trainer and a
detector, module to module; the detector's heads stay its own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.profiler import record_function

from boosted_detr_torch.config import ModelConfig, TrainConfig
from boosted_detr_torch.models import layers
from boosted_detr_torch.models.detr import _DTYPES, DETR, _resolve_device
from boosted_detr_torch.models.heads import MultiClassPredictionHead
from boosted_detr_torch.ops import losses as loss_ops


class DETRMultiClassifier(nn.Module):
    """The multi-label classifier over the shared DETR trunk
    (pretrainer.py:37-71), on ``device`` (default ``cuda``; raises without a
    GPU unless ``device="cpu"``), parameters drawn from ``seed``.
    ``config`` is the base model's; ``num_classifier_classes`` counts the
    pre-training vocabulary with <PAD> and <OOV>. The forward gives the
    best probability per class over the queries, [B, 1, C] float32 (a list
    of one a block with ``return_intermediate``)."""

    def __init__(self, config: ModelConfig, num_classifier_classes: int,
                 hidden_dim: int = 256, *, device=None, seed: int = 0):
        super().__init__()
        device = _resolve_device(device)
        self.config = cfg = config
        self.num_classifier_classes = num_classifier_classes
        self.detr = DETR(cfg, device="cpu", seed=seed, heads=False)
        self.classifier_head = MultiClassPredictionHead(
            cfg.decoder_dim, num_classifier_classes, hidden_dim,
            cfg.num_object_preds, cfg.norm, _DTYPES[cfg.compute_dtype])
        layers.reset_parameters(self.classifier_head,
                                torch.Generator().manual_seed(seed + 1))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.detr.device

    def forward(self, image: torch.Tensor, *, return_intermediate: bool = False,
                generator: Optional[torch.Generator] = None):
        generator = self.detr.training_generator(generator)
        outputs: List[torch.Tensor] = [
            self.classifier_head(dec).amax(dim=1, keepdim=True)
            for _, _, dec in self.detr.decode(image, return_intermediate,
                                              generator)]
        return outputs if return_intermediate else outputs[-1]


def pretrain_loss(preds_list: List[torch.Tensor],
                  category_ids: torch.Tensor,
                  num_classes: int) -> Dict[str, torch.Tensor]:
    """The pre-training loss (pretrainer.py:74-97): y is the multi-hot of
    the categories of the image (every row of ``category_ids`` one-hot,
    the padded rows included, as JAX's; an id outside the vocabulary gives
    a zero row); per block the focal loss summed over the classes, the
    least over the singleton query axis, summed over the blocks; ``loss``
    is the sum over the batch. ``accuracy`` is the final block's binary
    accuracy at 0.5."""
    ids = category_ids.long()
    y_hot = (ids[..., None] == torch.arange(
        num_classes, device=ids.device)).float()  # [B, O, C]
    y_multihot = y_hot.amax(dim=1, keepdim=True)  # [B, 1, C]
    total = 0.0
    for preds in preds_list:
        focal = loss_ops.sigmoid_focal_elementwise(
            y_multihot, preds.float()).sum(dim=-1)  # [B, 1]
        total = total + focal.amin(dim=1)  # [B]
    final = preds_list[-1]
    accuracy = ((final >= 0.5).float() == y_multihot).float().mean()
    return {"loss": total.sum(), "accuracy": accuracy}


def make_pretrain_step(model: DETRMultiClassifier, mesh=None):
    """The pre-training step (pretrainer.py:100-124): the training forward
    with every block's output (always intermediate), ``pretrain_loss``,
    then the backward and the optimizer the state holds (the port's
    ``make_optimizer``: SGD with Nesterov momentum behind the per-tensor
    clip, as JAX's ``state.tx``). ``train_step(state, batch,
    generator=None) -> (state, aux)``, the batch with ``image`` and
    ``category_ids``; the generator draws the dropout bits (without one,
    step ``s`` seeds its own from ``(TrainConfig().seed, s)``). Across
    processes the step runs under ``mesh`` (every rank on 'data' when
    None) and computes the global batch's step, its ``accuracy`` the
    global batch's too."""
    from boosted_detr_torch.parallel import mesh as mesh_lib
    from boosted_detr_torch.train import steps as steps_lib

    if mesh is None:
        mesh = mesh_lib.make_mesh(device=model.device)

    def loss_fn(model, batch, generator):
        with record_function("train_step/forward"):
            steps_lib.set_mode(model, True)
            outs = model(batch["image"], return_intermediate=True,
                         generator=generator)
        with record_function("train_step/loss_and_matching"):
            metrics = pretrain_loss(outs, batch["category_ids"],
                                    model.num_classifier_classes)
        return metrics["loss"], {"accuracy": metrics["accuracy"]}

    return steps_lib.seeded_step(model, TrainConfig().seed,
                                 steps_lib.make_update_step(loss_fn,
                                                            mesh=mesh))


def _copy_trunk(dst: nn.Module, src: nn.Module, trunk: nn.Module) -> None:
    """Every entry of ``trunk``'s state dict from ``src``'s into ``dst``'s,
    both of which must hold it at the same shape."""
    to, frm = dst.state_dict(), src.state_dict()
    odd = sorted(k for k in trunk.state_dict() if k not in to or k not in frm
                 or to[k].shape != frm[k].shape)
    if odd:
        raise KeyError(f"the trunks differ at {odd[:8]}")
    with torch.no_grad():
        for k in trunk.state_dict():
            to[k].copy_(frm[k])


def transfer_to_detr(pretrainer: DETRMultiClassifier, detr: DETR) -> DETR:
    """The pre-trained trunk (backbone, neck, encoder, decoder prep and
    blocks) into ``detr`` in place (pretrainer.py:130-155); its heads stay
    its own. Returns ``detr``."""
    _copy_trunk(detr, pretrainer.detr, pretrainer.detr)
    return detr


def load_from_detr(pretrainer: DETRMultiClassifier,
                   detr: DETR) -> DETRMultiClassifier:
    """A detector's trunk into ``pretrainer`` in place
    (pretrainer.py:158-165); the detector's heads have no place there.
    Returns ``pretrainer``."""
    _copy_trunk(pretrainer.detr, detr, pretrainer.detr)
    return pretrainer
