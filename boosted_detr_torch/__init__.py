"""Boosted DETR in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``boosted_detr_tpu`` (JAX, Flax, Pallas), which stays as the
reference. This package imports torch and never JAX or the JAX package.
It serves the flagship DETR today: ``DETR`` with the ResNet ``patchify8``
backbone, whose stem runs through the CUDA kernel in ``csrc/patchify.cu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from boosted_detr_torch.bridge import load_flax_variables
from boosted_detr_torch.config import ModelConfig
from boosted_detr_torch.models.detr import DETR
from boosted_detr_torch.train.steps import predict

__all__ = ["DETR", "ModelConfig", "load_flax_variables", "predict"]
