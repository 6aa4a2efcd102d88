"""Attention front-end.

Counterpart of `gpt_image_edit_tpu.ops.attention`: one entry point,
`dot_product_attention`, in BSHD layout with GQA, causal/segment/padding
masking, an additive bias and an fp32 softmax. It has one route: the K1
flash-attention wrapper (`ops.kernels.flash_attention`), which launches the
CUDA kernel on a CUDA tensor and runs the kernel's plain version on a CPU
tensor. The mask semantics are `_build_mask`'s in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpt_image_edit_tpu_torch.ops.kernels.flash_attention import flash_attention


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    pad_mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head attention in BSHD layout.

    Args:
      q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0 (GQA).
      causal: lower-triangular mask, aligned to the end for Sq < Skv.
      q_segment_ids / kv_segment_ids: (B, Sq)/(B, Skv) int; attention only
        within equal segment ids.
      pad_mask: (B, Skv) bool/int — 1 = attend, 0 = masked key.
      bias: optional additive (B or 1, H or 1, Sq, Skv) fp32 bias.
      scale: defaults to D ** -0.5.
    Returns: (B, Sq, Hq, D) in q.dtype; a row that sees no key is 0.
    """
    return flash_attention(
        q, k, v, causal=causal, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, pad_mask=pad_mask, bias=bias, scale=scale,
    )
