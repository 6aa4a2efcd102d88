"""FLUX latent token packing and rope-id generation.

Counterpart of `gpt_image_edit_tpu.ops.packing`. Latents are NHWC at the
port's boundary, as in the JAX package. Each token is a 2x2 patch of the
latent grid; packed feature index = c*4 + dy*2 + dx, which matches the
reference's NCHW `view(B,C,H/2,2,W/2,2).permute(0,2,4,1,3,5)` flattening.
"""

from __future__ import annotations

import torch


def pack_latents(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) NHWC latents -> (B, (H/2)*(W/2), C*4) tokens,
    out[..., c*4 + dy*2 + dx] = x[:, 2h+dy, 2w+dx, c]."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"latent H/W must be even, got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, h/2, w/2, C, 2, 2)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack_latents(tokens: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, S, C*4) tokens -> (B, H, W, C) NHWC latents; `height`/`width` are
    the latent grid dims (H, W), inverse of `pack_latents`."""
    b, s, cf = tokens.shape
    c = cf // 4
    hh, ww = height // 2, width // 2
    if s != hh * ww:
        raise ValueError(f"token count {s} != {hh}*{ww}")
    x = tokens.reshape(b, hh, ww, c, 2, 2)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, h/2, 2, w/2, 2, C)
    return x.reshape(b, height, width, c)


def latent_image_ids(height: int, width: int, modality: int = 0, device=None) -> torch.Tensor:
    """3-channel rope ids (modality, y, x) for a packed latent grid of
    `height` x `width` tokens (latent//2). Channel 0 is 0 for the target and
    k for the k-th Kontext reference image. Returns (height*width, 3) float32."""
    ids = torch.zeros(height, width, 3, dtype=torch.float32, device=device)
    ids[..., 0] = float(modality)
    ids[..., 1] += torch.arange(height, dtype=torch.float32, device=device)[:, None]
    ids[..., 2] += torch.arange(width, dtype=torch.float32, device=device)[None, :]
    return ids.reshape(height * width, 3)
