"""Keras-like Trainer: compile()/fit()/evaluate()/predict().

Counterpart of boosted_detr_tpu/train/trainer.py over the port's steps
(train/steps.py):

- ``compile`` builds the optimizer from ``model.named_parameters()`` (so
  that ``agc_clip`` reads each leaf's layout from its name), with staged
  freezing through ``boosted_block_mask`` when ``train_block`` is set, the
  train, eval and predict steps (a ``DETRPanoptic`` takes the panoptic
  ones), and restores from ``checkpoint_dir`` when a checkpoint is there;
- ``fit`` is the epoch loop: the batches onto the device, the NaN guard
  (``NaNLossError``), ``steps_per_epoch``, validation, CSV and TensorBoard
  logs, checkpoints every ``checkpoint_every_epochs`` keeping the latest
  ``keep_checkpoints``, ``batch_fn`` and ``scan_steps``;
- ``evaluate`` is the training loss without updates; ``predict`` decodes
  raw probabilities to text with the host codec, with early exit.

What differs from JAX, and why:
- The model holds its weights from its construction (seeded, or loaded
  through ``bridge.load_flax_variables``), so ``compile`` initialises
  nothing; ``sample_batch`` is only checked against the config's image
  size.
- ``scan_steps > 1``: JAX runs a group of steps as one ``lax.scan``
  dispatch. Here the group's steps run one after another and the losses
  are read back once a group, so a group of N costs one readback instead
  of N. Each step draws its dropout bits from ``(seed, step)``
  (``steps.seeded_step``), so grouping changes no result.
- JAX turns each batch into numpy arrays; here a tensor already on the
  device stays where it is (``prefetch_to_device`` and ``batch_fn`` make
  such batches), and numpy arrays are copied there.
- Checkpoints are ``torch.save`` files: the model's state dict (BatchNorm
  running statistics included), the optimizer's state (the momentum) and
  its ``count``, the EMA shadow and ``step``. A restored run goes on bit
  for bit, since the step's dropout generator comes from ``(seed, step)``.
  ``torch.save`` writes before it returns, so ``save(wait=False)`` waits
  too.
- ``export_serving`` (a StableHLO artifact in JAX) and ``mesh_shape`` are
  not ported (ROADMAP.md, Queue 1 items 4 and 5).

``device`` is ``cuda`` unless the caller passes another; the model must
lie there.
"""

from __future__ import annotations

import csv
import os
import re
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from boosted_detr_torch.config import ModelConfig, TrainConfig
from boosted_detr_torch.data.codec import TextCodec
from boosted_detr_torch.train import steps as steps_lib


class NaNLossError(RuntimeError):
    pass


class Trainer:
    BATCH_KEYS = ("image", "category_ids", "attribute_ids", "bbox",
                  "num_objects", "masks")

    def __init__(self, model, model_cfg: ModelConfig,
                 train_cfg: TrainConfig,
                 codec: Optional[TextCodec] = None, device=None):
        from boosted_detr_torch.models.detr import _resolve_device

        self.device = _resolve_device(device)
        held = {p.device for p in model.parameters()}
        if any(d.type != self.device.type or self.device.index not in (
                None, d.index) for d in held):
            raise ValueError(f"the model lies on {sorted(map(str, held))}, "
                             f"not on the Trainer's device {self.device}")
        self.model = model
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.codec = codec
        self.state: Optional[steps_lib.TrainState] = None
        self._train_step = None
        self._eval_step = None
        self._ckpt: Optional[_Checkpoints] = None

    # -- building --------------------------------------------------------

    def _trainable_mask(self):
        """``train_block=k`` trains weak learner k's leaves (and the shared
        queries) alone, everything else frozen, the backbone included."""
        k = self.train_cfg.train_block
        if k is None:
            return None
        return steps_lib.boosted_block_mask(self.model, k)

    def _is_panoptic(self) -> bool:
        from boosted_detr_torch.models.panoptic import DETRPanoptic

        return isinstance(self.model, DETRPanoptic)

    def _make_eval_step(self, model):
        if self._is_panoptic():
            from boosted_detr_torch.models import panoptic

            return panoptic.make_panoptic_eval_step(model, self.train_cfg)
        return steps_lib.make_eval_step(model, self.model_cfg, self.train_cfg)

    def compile(self, optimizer=None, sample_batch=None):
        """Build the optimizer, the steps and the state. ``optimizer`` may
        be a ready ``steps.Optimizer`` (``make_optimizer``'s type over this
        model's parameters); ``train_block`` freezing applies to it too.
        ``sample_batch``, where given, must hold images of the config's
        size. Restores from ``checkpoint_dir`` when a checkpoint is
        there."""
        if sample_batch is not None:
            shape = tuple(np.shape(sample_batch["image"]))[1:3]
            if shape != tuple(self.model_cfg.image_size):
                raise ValueError(f"sample images are {shape}, the config's "
                                 f"{tuple(self.model_cfg.image_size)}")
        mask = self._trainable_mask()
        named = list(self.model.named_parameters())
        if optimizer is not None:
            tx = (steps_lib.apply_trainable_mask(optimizer, named, mask)
                  if mask is not None else optimizer)
        else:
            tx = steps_lib.make_optimizer(
                self.train_cfg, named, d_model=self.model_cfg.decoder_dim,
                trainable_mask=mask)
        self.state = steps_lib.TrainState.create(
            self.model, tx, ema=self.train_cfg.ema_decay > 0.0)
        if self._is_panoptic():
            from boosted_detr_torch.models import panoptic

            self._train_step = panoptic.make_panoptic_train_step(
                self.model, self.train_cfg)
        else:
            self._train_step = steps_lib.make_train_step(
                self.model, self.model_cfg, self.train_cfg)
        self._eval_step = self._make_eval_step(self.model)
        if self.train_cfg.checkpoint_dir:
            self._ckpt = _Checkpoints(self.train_cfg.checkpoint_dir,
                                      keep=self.train_cfg.keep_checkpoints)
            self.restore()  # resume if a checkpoint exists
        return self

    def _require_state(self):
        if self.state is None:
            raise RuntimeError("call compile() first")

    # -- checkpointing ----------------------------------------------------

    def _payload(self) -> Dict:
        state = self.state
        payload = {"step": state.step,
                   "model": state.model.state_dict(),
                   "optimizer": state.optimizer.inner.state_dict(),
                   "count": state.optimizer.count}
        if state.ema_params is not None:
            payload["ema_params"] = state.ema_params
        return payload

    def _load_ema(self, saved: Optional[Dict]) -> None:
        """The EMA shadow from ``saved`` when both sides have one; an EMA
        state restoring a checkpoint without one re-seeds it from the
        restored parameters, and a shadow the state has no use for is
        dropped."""
        state = self.state
        if state.ema_params is None:
            return
        source = saved if saved is not None else dict(
            state.model.named_parameters())
        with torch.no_grad():
            for name, e in state.ema_params.items():
                e.copy_(source[name])

    def save(self, step: Optional[int] = None, wait: bool = True):
        """Checkpoint the whole train state into ``checkpoint_dir`` (nothing
        without one), keeping the latest ``keep_checkpoints``."""
        if self._ckpt is None:
            return
        self._require_state()
        step = self.state.step if step is None else step
        self._ckpt.save(step, self._payload())

    def restore(self) -> bool:
        """The latest checkpoint of ``checkpoint_dir`` into the state;
        False when there is none."""
        if self._ckpt is None:
            return False
        saved = self._ckpt.latest()
        if saved is None:
            return False
        state = self.state
        state.model.load_state_dict(saved["model"])
        state.optimizer.inner.load_state_dict(saved["optimizer"])
        state.optimizer.count = int(saved["count"])
        state.step = int(saved["step"])
        self._load_ema(saved.get("ema_params"))
        return True

    def save_weights(self, path: str):
        """The model's state dict (BatchNorm running statistics included),
        and the EMA shadow when the state has one, to one file."""
        self._require_state()
        payload = {"model": self.state.model.state_dict()}
        if self.state.ema_params is not None:
            payload["ema_params"] = self.state.ema_params
        _atomic_save(payload, path)

    def load_weights(self, path: str):
        """Weights saved by ``save_weights``; the EMA shadow as ``restore``
        takes it."""
        self._require_state()
        saved = torch.load(path, map_location=self.device, weights_only=True)
        self.state.model.load_state_dict(saved["model"])
        self._load_ema(saved.get("ema_params"))

    def load_pretrained_backbone(self, source: str):
        """Offline pretrained ResNet weights (an npz in the documented
        layout, or a torchvision-style state dict; models/pretrained.py)
        into the live model; a ``DETRPanoptic``'s backbone is its
        ``detr``'s."""
        from boosted_detr_torch.models import pretrained

        pretrained.load_pretrained_backbone(self.model, source)
        return self

    # -- loops ------------------------------------------------------------

    def _place(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's model inputs as tensors on the device: numpy arrays
        are copied there, a tensor already there stays."""
        out = {}
        for k, v in batch.items():
            if k not in self.BATCH_KEYS:
                continue
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.asarray(v))
            out[k] = v.to(self.device)
        return out

    def fit(self, batches: Iterable[Dict], epochs: int = 1,
            steps_per_epoch: Optional[int] = None,
            validation_batches: Optional[Iterable] = None,
            log_path: Optional[str] = None,
            tensorboard_dir: Optional[str] = None,
            log_every: int = 10,
            checkpoint_every_epochs: int = 1,
            batch_fn: Optional[Callable] = None,
            scan_steps: int = 1) -> Dict[str, list]:
        """``batches``: an iterable (or a callable returning one per epoch)
        of batch dicts, numpy arrays or tensors; ``batch_fn`` maps each
        item to a batch first. Raises ``NaNLossError`` on a non-finite
        loss and ``ValueError`` when an epoch finds no batch.

        ``scan_steps > 1`` groups that many consecutive batches: their
        steps run in order and their losses are read back once, after the
        group (a partial group at an epoch's end too)."""
        self._require_state()
        history = {"loss": [], "val_loss": []}
        writer = _CsvLogger(log_path) if log_path else None
        tb = _TensorBoardLogger(tensorboard_dir) if tensorboard_dir else None
        group = max(scan_steps, 1)
        try:
            for epoch in range(epochs):
                it = batches() if callable(batches) else batches
                t0 = time.time()
                n_steps = 0
                running = 0.0
                pending: List[Dict] = []

                def run_pending():
                    nonlocal running, n_steps
                    if not pending:
                        return
                    auxes = []
                    for b in pending:
                        self.state, aux = self._train_step(self.state, b)
                        auxes.append(aux)
                    losses = [float(x) for x in torch.stack(
                        [a["loss"] for a in auxes]).cpu()]
                    for loss in losses:
                        if not np.isfinite(loss):
                            raise NaNLossError(
                                f"non-finite loss at step {self.state.step}")
                        running += loss
                        n_steps += 1
                    scalars = {k: float(v.reshape(-1)[-1])
                               for k, v in auxes[-1].items()}
                    if n_steps % log_every < len(losses):
                        if writer:
                            writer.write(self.state.step, scalars)
                        if tb:
                            tb.write(self.state.step, scalars)
                    pending.clear()

                stop_epoch = False
                for batch in it:
                    if batch_fn is not None:
                        batch = batch_fn(batch)
                    pending.append(self._place(batch))
                    if len(pending) >= group:
                        run_pending()
                    if steps_per_epoch and n_steps >= steps_per_epoch:
                        stop_epoch = True
                        break
                if not stop_epoch:
                    run_pending()
                else:
                    pending.clear()
                if n_steps == 0:
                    raise ValueError(
                        "the batch iterable was empty this epoch — pass a "
                        "CALLABLE returning a fresh iterator per epoch (a "
                        "plain generator is exhausted after the first "
                        "epoch)")
                epoch_loss = running / n_steps
                history["loss"].append(epoch_loss)
                msg = (f"epoch {epoch + 1}/{epochs}: loss={epoch_loss:.4f} "
                       f"steps={n_steps} ({time.time() - t0:.1f}s)")
                if validation_batches is not None:
                    vit = (validation_batches() if callable(
                        validation_batches) else validation_batches)
                    v_losses = [float(self._eval_step(
                        self.state, self._place(b))["loss"]) for b in vit]
                    val = (float(np.mean(v_losses)) if v_losses
                           else float("nan"))
                    history["val_loss"].append(val)
                    msg += f" val_loss={val:.4f}"
                print(msg, flush=True)
                if self._ckpt and (epoch + 1) % checkpoint_every_epochs == 0:
                    self.save()
        finally:
            if writer:
                writer.close()
            if tb:
                tb.close()
        return history

    def _read_state(self, use_ema: bool = False) -> steps_lib.TrainState:
        """The state of read-only passes (eval, predict): the live one, or
        with ``use_ema`` a state whose model holds the EMA shadow
        (``with_ema_params``; TrainConfig.ema_decay > 0)."""
        self._require_state()
        return (steps_lib.with_ema_params(self.state) if use_ema
                else self.state)

    def evaluate(self, batches: Iterable,
                 use_ema: bool = False) -> Dict[str, float]:
        """The eval step's aux dict (``loss`` and its parts) averaged over
        ``batches``."""
        state = self._read_state(use_ema)
        step = (self._eval_step if state.model is self.model
                else self._make_eval_step(state.model))
        sums: Dict[str, float] = {}
        n = 0
        for batch in batches:
            aux = step(state, self._place(batch))
            for k, v in aux.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {k: v / max(n, 1) for k, v in sums.items()}

    def export_serving(self, path: str) -> str:
        raise NotImplementedError(
            "Trainer.export_serving is not ported yet (ROADMAP.md, Queue 1 "
            "item 4: api, cli and serving)")

    def export_inference_fn(self):
        """A serving callable with the current weights: images ->
        (category_strings, attribute_strings, boxes) through the host
        codec, or the raw prediction dict without one."""
        self._require_state()
        model, codec = self.state.model, self.codec

        def serve(images):
            return steps_lib.predict(model, images, codec)

        return serve

    def predict(self, images, decode_text: bool = True,
                early_exit_threshold: Optional[float] = None,
                use_ema: bool = False):
        """Images [B, H, W, 3] in [0, 1] (numpy, or a tensor) ->
        (category_strings, attribute_strings, boxes) through the codec, or
        the raw probability dict when ``decode_text`` is False.
        ``early_exit_threshold`` (``ModelConfig.early_exit_threshold`` when
        None) is adaptive-depth inference by
        ``ModelConfig.early_exit_criterion``; ``use_ema`` serves the EMA
        shadow."""
        state = self._read_state(use_ema)
        threshold = (early_exit_threshold
                     if early_exit_threshold is not None
                     else self.model_cfg.early_exit_threshold)
        return steps_lib.predict(state.model, images,
                                 self.codec if decode_text else None,
                                 decode_text=decode_text,
                                 early_exit_threshold=threshold)


def _atomic_save(payload, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class _Checkpoints:
    """``ckpt_<step>.pt`` files in one directory, the latest ``keep``
    kept."""

    _NAME = re.compile(r"^ckpt_(\d+)\.pt$")

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := self._NAME.match(f)))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def save(self, step: int, payload: Dict) -> None:
        _atomic_save(payload, self.path(step))
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self.path(old))

    def latest(self) -> Optional[Dict]:
        steps = self.steps()
        if not steps:
            return None
        return torch.load(self.path(steps[-1]), map_location="cpu",
                          weights_only=True)


class _TensorBoardLogger:
    """TensorBoard scalars through ``torch.utils.tensorboard`` (which needs
    the ``tensorboard`` package, imported here)."""

    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(logdir)

    def write(self, step: int, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self._writer.add_scalar(k, v, global_step=step)

    def close(self):
        self._writer.close()


class _CsvLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", newline="")
        self._writer = None

    def write(self, step: int, metrics: Dict[str, float]):
        row = {"step": step, **metrics}
        if self._writer is None:
            self._writer = csv.DictWriter(self._f, fieldnames=list(row))
            if self._f.tell() == 0:
                self._writer.writeheader()
        self._writer.writerow(row)
        self._f.flush()

    def close(self):
        self._f.close()
