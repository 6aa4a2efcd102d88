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

from gpt_image_edit_tpu_torch.models import clip as clip_mod
from gpt_image_edit_tpu_torch.models import t5 as t5_mod
from gpt_image_edit_tpu_torch.models.flux.config import FluxConfig
from gpt_image_edit_tpu_torch.models.flux.model import init as init_flux
from gpt_image_edit_tpu_torch.models.qwen2p5vl.config import Qwen2p5VLConfig
from gpt_image_edit_tpu_torch.models.qwen2p5vl.model import init as init_qwen
from gpt_image_edit_tpu_torch.models.vae.config import VaeConfig
from gpt_image_edit_tpu_torch.models.vae.model import init as init_vae
from gpt_image_edit_tpu_torch.utils.platform import resolve_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _build(init, cfg, seed, device, dtype):
    device = resolve_device(device)
    return init(cfg, generator=_generator(seed, device), device=device, dtype=dtype)


def synthetic_flux(cfg: FluxConfig, *, seed: int = 0, device="cuda", dtype=torch.bfloat16):
    """Random FLUX param tree (JAX layout) built on `device` in `dtype`."""
    return _build(init_flux, cfg, seed, device, dtype)


def synthetic_vae(cfg: VaeConfig, *, seed: int = 1, device="cuda", dtype=torch.bfloat16):
    """Random VAE param tree (OIHW convs) built on `device` in `dtype`."""
    return _build(init_vae, cfg, seed, device, dtype)


def synthetic_qwen(cfg: Qwen2p5VLConfig, *, seed: int = 2, device="cuda", dtype=torch.bfloat16):
    """Random Qwen2.5-VL tree (ViT, LM trunk, lm_head, MLP2 projector)."""
    return _build(init_qwen, cfg, seed, device, dtype)


def synthetic_t5(cfg: t5_mod.T5Config, *, seed: int = 3, device="cuda", dtype=torch.bfloat16):
    """Random T5 encoder tree."""
    return _build(t5_mod.init, cfg, seed, device, dtype)


def synthetic_clip(cfg: clip_mod.ClipTextConfig, *, seed: int = 4, device="cuda",
                   dtype=torch.bfloat16):
    """Random CLIP text encoder tree."""
    return _build(clip_mod.init, cfg, seed, device, dtype)
