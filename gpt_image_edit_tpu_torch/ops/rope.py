"""Rotary position embeddings, the counterpart of `gpt_image_edit_tpu.ops.rope`.

Two conventions that must not be mixed:
- paired (FLUX): features are rotated in adjacent pairs (0,1), (2,3), ...;
  cos/sin are interleaved [c0,c0,c1,c1,...] per axis (diffusers
  FluxPosEmbed, repeat_interleave_real);
- halves (the Qwen2.5-VL LM and ViT): rotate_half splits the head dim in
  two; cos/sin are [c0..c{d/2-1}, c0..c{d/2-1}].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def flux_rope_freqs(
    ids: torch.Tensor,
    axes_dim: Sequence[int] = (16, 56, 56),
    theta: float = 10000.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for FLUX joint attention.

    ids: (S, 3) float — (modality, y, x) per token (text ids are all-zero).
    Returns (cos, sin), each (S, sum(axes_dim)) float32, interleaved layout
    [c0,c0,c1,c1,...] per axis then concatenated across axes.
    """
    cos_parts = []
    sin_parts = []
    for i, dim in enumerate(axes_dim):
        pos = ids[:, i].float()  # (S,)
        half = dim // 2
        exponent = torch.arange(0, half, dtype=torch.float32, device=ids.device) * 2.0 / dim
        freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=ids.device), exponent)
        angles = pos[:, None] * freqs[None, :]  # (S, half)
        angles = torch.repeat_interleave(angles, 2, dim=-1)  # (S, dim)
        cos_parts.append(torch.cos(angles))
        sin_parts.append(torch.sin(angles))
    return torch.cat(cos_parts, dim=-1), torch.cat(sin_parts, dim=-1)


def apply_rope_paired(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent feature pairs. x: (..., S, D); cos/sin: (S, D), or any
    shape that broadcasts against x — (S, 1, D) tables rotate a BSHD tensor.

    Computes in the cos/sin dtype: f32 tables give the reference-faithful
    fp32 rotation; bf16 tables keep the whole rotation in bf16
    (FluxConfig.rope_dtype)."""
    dtype = x.dtype
    xf = x.to(cos.dtype)
    x_even = xf[..., 0::2]
    x_odd = xf[..., 1::2]
    rotated = torch.stack([-x_odd, x_even], dim=-1).reshape(xf.shape)
    out = xf * cos + rotated * sin
    return out.to(dtype)


# --------------------------------------------------------------------------
# Qwen M-RoPE (halves convention: rotate_half splits the head dim in two)
# --------------------------------------------------------------------------

def mrope_freqs(position_ids: torch.Tensor, head_dim: int,
                mrope_section: Sequence[int] = (16, 24, 24),
                theta: float = 1000000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin for Qwen2.5-VL multimodal rope.

    position_ids: (3, B, S) int, the (t, h, w) position per token. Returns
    (cos, sin), each (B, S, head_dim) float32, halves layout: the half head
    dim is [sec0 from t, sec1 from h, sec2 from w], repeated twice."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=position_ids.device) * 2.0 / head_dim
    inv_freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=position_ids.device),
                               exponent)
    angles = position_ids.float()[..., None] * inv_freq  # (3, B, S, half)

    def mix(tab):
        parts, start = [], 0
        for i, sec in enumerate(mrope_section):
            parts.append(tab[i, ..., start:start + sec])
            start += sec
        mixed = torch.cat(parts, dim=-1)
        return torch.cat([mixed, mixed], dim=-1)

    return mix(torch.cos(angles)), mix(torch.sin(angles))


def apply_rope_halves(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-convention rotation, in the table dtype. cos/sin broadcast against
    x: (S, D) tables rotate (B, H, S, D), (B, S, 1, D) tables rotate BSHD."""
    dtype = x.dtype
    xf = x.to(cos.dtype)
    half = xf.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(dtype)
