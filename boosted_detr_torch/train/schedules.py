"""Learning-rate schedules: functions from the optimizer step count (from 0,
as optax counts) to a learning rate, evaluated on the host.

Counterpart of boosted_detr_tpu/train/schedules.py:17-73: the 'Attention Is
All You Need' warm-up schedule with its optional cyclic restart, Keras'
``CosineDecayRestarts`` (SGDR) and a constant. The JAX package evaluates
them in float32 on the device; here they are evaluated in float32 on the
host with numpy, so that a step reads nothing back from the card.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32


def aiayn_schedule(d_model: int, warmup_steps: int = 4000,
                   scale: float = 1.0, cycle_steps: int = 0):
    """``d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)`` with the step
    floored at 1 and, when ``cycle_steps``, wrapped every ``cycle_steps``."""

    def schedule(step) -> float:
        step = np.maximum(_F32(step), _F32(1.0))
        if cycle_steps:
            step = np.mod(step - _F32(1.0), _F32(cycle_steps)) + _F32(1.0)
        return float(_F32(scale * d_model ** -0.5) * np.minimum(
            step ** _F32(-0.5), step * _F32(warmup_steps ** -1.5)))

    return schedule


def cosine_decay_restarts(initial_lr: float, first_decay_steps: int,
                          t_mul: float = 2.0, m_mul: float = 1.0,
                          alpha: float = 0.0):
    """Keras ``CosineDecayRestarts``: each period ``t_mul`` times longer and
    ``m_mul`` times shallower than the one before, floored at
    ``alpha * initial_lr``."""

    def schedule(step) -> float:
        p = _F32(step) / _F32(first_decay_steps)
        if t_mul == 1.0:
            i_restart = np.floor(p)
            t = p - i_restart
        else:
            i_restart = np.floor(np.log1p(p * _F32(t_mul - 1.0))
                                 / _F32(math.log(t_mul)))
            sum_r = (_F32(t_mul) ** i_restart - _F32(1.0)) / _F32(t_mul - 1.0)
            t = (p - sum_r) / _F32(t_mul) ** i_restart
        m_fac = _F32(m_mul) ** i_restart
        cosine = _F32(0.5) * m_fac * (_F32(1.0) + np.cos(_F32(math.pi) * t))
        decayed = _F32(1.0 - alpha) * cosine + _F32(alpha)
        return float(_F32(initial_lr) * decayed)

    return schedule


def constant(lr: float):
    return lambda step: float(_F32(lr))


def make_schedule(name: str, learning_rate: float, warmup_steps: int,
                  d_model: int = 256):
    if name == "cosine_restarts":
        # the reference notebooks' settings
        return cosine_decay_restarts(learning_rate, warmup_steps,
                                     t_mul=2.0, m_mul=0.95, alpha=0.1)
    if name == "aiayn":
        return aiayn_schedule(d_model, warmup_steps)
    if name == "constant":
        return constant(learning_rate)
    raise ValueError(f"unknown schedule '{name}'")
