"""Flow-matching Euler schedule (FlowMatchEulerDiscreteScheduler equivalent).

A copy of `gpt_image_edit_tpu.pipeline.scheduler` (pure numpy): Kontext's
resolution-dependent dynamic shifting as a pair of pure functions producing
a static fp32 sigma table that the sampler loops over.

Forward (noising) process:  x_sigma = (1 - sigma) * x0 + sigma * noise
Velocity target:            v = noise - x0
Euler step:                 x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v
"""

from __future__ import annotations

import math

import numpy as np


def calculate_shift(
    image_seq_len: int,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> float:
    """mu for dynamic schedule shifting."""
    m = (max_shift - base_shift) / (max_seq_len - base_seq_len)
    b = base_shift - m * base_seq_len
    return image_seq_len * m + b


def shift_sigmas(sigmas: np.ndarray, mu: float) -> np.ndarray:
    """Time-shift: sigma' = e^mu * s / (1 + (e^mu - 1) * s)."""
    shift = math.exp(mu)
    return shift * sigmas / (1.0 + (shift - 1.0) * sigmas)


def flow_sigmas(
    num_steps: int,
    image_seq_len: int,
    *,
    base_seq_len: int = 256,
    max_seq_len: int = 4096,
    base_shift: float = 0.5,
    max_shift: float = 1.15,
) -> np.ndarray:
    """(num_steps + 1,) fp32 sigma table incl. terminal 0.

    sigmas = linspace(1, 1/n, n) dynamically shifted by the packed target
    token count.
    """
    sigmas = np.linspace(1.0, 1.0 / num_steps, num_steps, dtype=np.float64)
    mu = calculate_shift(image_seq_len, base_seq_len, max_seq_len, base_shift, max_shift)
    sigmas = shift_sigmas(sigmas, mu)
    return np.concatenate([sigmas, [0.0]]).astype(np.float32)
