"""FLUX AutoencoderKL (encoder + decoder), NHWC at the boundary.

Counterpart of `gpt_image_edit_tpu.models.vae.model`: diffusers
AutoencoderKL as configured in the FLUX checkpoints (16 latent channels,
block_out_channels (128, 256, 512, 512), no quant convs). Encode returns the
distribution mean. Images and latents are NHWC tensors; the convolutions run
on their NCHW views, which PyTorch takes as channels_last. The mid-block
attention is plain softmax attention, as in the JAX package (there it is an
einsum, not a Pallas kernel).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gpt_image_edit_tpu_torch.models.common import (
    Params,
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    linear,
    linear_init,
)
from gpt_image_edit_tpu_torch.models.vae.config import VaeConfig


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _resnet(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    h = conv2d(p["conv1"], F.silu(group_norm(p["norm1"], x, num_groups=groups)))
    h = conv2d(p["conv2"], F.silu(group_norm(p["norm2"], h, num_groups=groups)))
    if "shortcut" in p:
        x = conv2d(p["shortcut"], x)
    return x + h


def _attn(p: Params, x: torch.Tensor, groups: int) -> torch.Tensor:
    """Single-head self-attention over the spatial grid (VAE mid-block)."""
    b, hh, ww, c = x.shape
    h = group_norm(p["norm"], x, num_groups=groups).reshape(b, hh * ww, c)
    q = linear(p["to_q"], h)
    k = linear(p["to_k"], h)
    v = linear(p["to_v"], h)
    logits = torch.matmul(q.float(), k.float().transpose(1, 2))  # fp32 scores
    probs = torch.softmax(logits * (c ** -0.5), dim=-1).to(x.dtype)
    out = torch.matmul(probs, v)
    out = linear(p["to_out"], out).reshape(b, hh, ww, c)
    return x + out


def _downsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-2 conv with diffusers' asymmetric (0, 1) padding."""
    return conv2d(p, x, stride=2, padding=[(0, 1), (0, 1)])


def _upsample(p: Params, x: torch.Tensor) -> torch.Tensor:
    x = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)
    return conv2d(p, x)


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(cfg: VaeConfig, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    """A random param tree with the JAX `init`'s structure and distributions
    (OIHW conv kernels), every leaf made directly on `device` in `dtype`."""
    kw = dict(device=device, dtype=dtype)

    def conv(i, o, k):
        return conv2d_init(generator, i, o, k, **kw)

    def resnet(i, o):
        p = {"norm1": group_norm_init(i, **kw), "conv1": conv(i, o, 3),
             "norm2": group_norm_init(o, **kw), "conv2": conv(o, o, 3)}
        if i != o:
            p["shortcut"] = conv(i, o, 1)
        return p

    def attn(c):
        return {"norm": group_norm_init(c, **kw),
                **{n: linear_init(generator, c, c, **kw) for n in ("to_q", "to_k", "to_v", "to_out")}}

    def mid(c):
        return {"resnet1": resnet(c, c), "attn": attn(c), "resnet2": resnet(c, c)}

    chans = cfg.block_out_channels
    n_stages = len(chans)
    enc: Params = {"conv_in": conv(cfg.in_channels, chans[0], 3)}
    ch = chans[0]
    down = []
    for i, out_ch in enumerate(chans):
        block: Params = {"resnets": [resnet(ch if j == 0 else out_ch, out_ch)
                                     for j in range(cfg.layers_per_block)]}
        ch = out_ch
        if i < n_stages - 1:
            block["downsample"] = conv(ch, ch, 3)
        down.append(block)
    enc["down_blocks"] = down
    enc["mid"] = mid(ch)
    enc["norm_out"] = group_norm_init(ch, **kw)
    enc["conv_out"] = conv(ch, 2 * cfg.latent_channels, 3)

    ch = chans[-1]
    dec: Params = {"conv_in": conv(cfg.latent_channels, ch, 3), "mid": mid(ch)}
    up = []
    for i, out_ch in enumerate(reversed(chans)):
        block = {"resnets": [resnet(ch if j == 0 else out_ch, out_ch)
                             for j in range(cfg.layers_per_block + 1)]}
        ch = out_ch
        if i < n_stages - 1:
            block["upsample"] = conv(ch, ch, 3)
        up.append(block)
    dec["up_blocks"] = up
    dec["norm_out"] = group_norm_init(ch, **kw)
    dec["conv_out"] = conv(ch, cfg.out_channels, 3)
    return {"encoder": enc, "decoder": dec}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def encode(params: Params, cfg: VaeConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [-1, 1] -> latent mean (B, H/8, W/8, C_lat)."""
    g = cfg.norm_num_groups
    enc = params["encoder"]
    h = conv2d(enc["conv_in"], x)
    for block in enc["down_blocks"]:
        for res in block["resnets"]:
            h = _resnet(res, h, g)
        if "downsample" in block:
            h = _downsample(block["downsample"], h)
    h = _resnet(enc["mid"]["resnet1"], h, g)
    h = _attn(enc["mid"]["attn"], h, g)
    h = _resnet(enc["mid"]["resnet2"], h, g)
    h = conv2d(enc["conv_out"], F.silu(group_norm(enc["norm_out"], h, num_groups=g)))
    mean, _logvar = torch.chunk(h, 2, dim=-1)
    return mean


def decode(params: Params, cfg: VaeConfig, z: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C_lat) raw latents -> (B, 8h, 8w, 3) in [-1, 1]."""
    g = cfg.norm_num_groups
    dec = params["decoder"]
    h = conv2d(dec["conv_in"], z)
    h = _resnet(dec["mid"]["resnet1"], h, g)
    h = _attn(dec["mid"]["attn"], h, g)
    h = _resnet(dec["mid"]["resnet2"], h, g)
    for block in dec["up_blocks"]:
        for res in block["resnets"]:
            h = _resnet(res, h, g)
        if "upsample" in block:
            h = _upsample(block["upsample"], h)
    return conv2d(dec["conv_out"], F.silu(group_norm(dec["norm_out"], h, num_groups=g)))


def encode_to_scaled_latents(params: Params, cfg: VaeConfig, x: torch.Tensor) -> torch.Tensor:
    """Pixel -> model latent space: (mean - shift) * scale."""
    return (encode(params, cfg, x) - cfg.shift_factor) * cfg.scaling_factor


def decode_from_scaled_latents(params: Params, cfg: VaeConfig, z: torch.Tensor) -> torch.Tensor:
    """Model latent space -> pixels: decode(z / scale + shift)."""
    return decode(params, cfg, z / cfg.scaling_factor + cfg.shift_factor)
