"""Attention front-end.

Counterpart of `gpt_image_edit_tpu.ops.attention`: one entry point,
`dot_product_attention`, in BSHD layout with GQA, causal/segment/padding
masking, an additive bias and an fp32 softmax. Three kernel routes, each a
kernel wrapper that launches its CUDA kernel on a CUDA tensor and runs the
kernel's plain version on a CPU tensor:
  - impl="auto": K1 (`ops.kernels.flash_attention`), every mask;
  - impl="pallas_qk8": K3 (`ops.kernels.flash_attention_qk8`), int8 q k^T
    for W8A8 serving, a kv pad mask only (no causal, segments or bias);
  - impl="pallas_int8": K4 (`ops.kernels.flash_attention_int8`), int8 q k^T
    and int8 p v for `--quantize w8a8-attn`; causal, segments and a pad
    mask, no bias (the JAX front end drops a bias here; this one raises).
A row whose keys are all masked gives 0 on every route. The mask semantics
are `_build_mask`'s in the JAX package. The JAX package's "xla" route is
plain XLA, no TPU kernel: the models that ask for it (T5, CLIP) run on K1
here. Its "pallas" and "ring" routes are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from gpt_image_edit_tpu_torch.ops.kernels.flash_attention import flash_attention
from gpt_image_edit_tpu_torch.ops.kernels.flash_attention_int8 import flash_attention_int8
from gpt_image_edit_tpu_torch.ops.kernels.flash_attention_qk8 import flash_attention_qk8


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
    impl: str = "auto",
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
      impl: "auto" (K1), "pallas_qk8" (K3: pad_mask only) or "pallas_int8"
        (K4: no bias).
    Returns: (B, Sq, Hq, D) in q.dtype; a row that sees no key is 0.
    """
    if impl == "pallas_qk8":
        if causal or q_segment_ids is not None or kv_segment_ids is not None or bias is not None:
            raise ValueError("pallas_qk8 supports pad_mask only (no causal/segments/bias)")
        return flash_attention_qk8(q, k, v, pad_mask=pad_mask, scale=scale)
    masks = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                 pad_mask=pad_mask, scale=scale)
    if impl == "pallas_int8":
        if bias is not None:
            raise ValueError("pallas_int8 takes no bias")
        return flash_attention_int8(q, k, v, **masks)
    if impl != "auto":
        raise ValueError(f"impl={impl!r}; the port has 'auto', 'pallas_qk8' and 'pallas_int8'")
    return flash_attention(q, k, v, bias=bias, **masks)
