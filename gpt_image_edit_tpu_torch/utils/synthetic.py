"""Synthetic full-size parameter trees for running the port without a checkpoint.

Counterpart of `gpt_image_edit_tpu.utils.synthetic` at serving size. Every
leaf is drawn directly on the device in the serving dtype (bf16) from a
seeded torch.Generator, so a 12B FLUX never exists in fp32 or on the host.
Kernels are scaled random values (the models' own init distributions), not
a constant fill: constant weights would make every attention row the same
and leave the kernels' masking and softmax untested.
"""

from __future__ import annotations

import torch

from gpt_image_edit_tpu_torch.models.flux.config import FluxConfig
from gpt_image_edit_tpu_torch.models.flux.model import init as init_flux
from gpt_image_edit_tpu_torch.models.vae.config import VaeConfig
from gpt_image_edit_tpu_torch.models.vae.model import init as init_vae
from gpt_image_edit_tpu_torch.utils.platform import resolve_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def synthetic_flux(cfg: FluxConfig, *, seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """Random FLUX param tree (JAX layout) built on `device` in `dtype`."""
    device = resolve_device(device)
    return init_flux(cfg, generator=_generator(seed, device), device=device, dtype=dtype)


def synthetic_vae(cfg: VaeConfig, *, seed: int = 1, device="cuda", dtype=torch.bfloat16):
    """Random VAE param tree (OIHW convs) built on `device` in `dtype`."""
    device = resolve_device(device)
    return init_vae(cfg, generator=_generator(seed, device), device=device, dtype=dtype)
