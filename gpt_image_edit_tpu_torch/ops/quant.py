"""Dynamic int8 row quantization of activations, the format W8A8 products
take: per row, scale = max(absmax / 127, 1e-8) in fp32 and codes
round-half-to-even, clipped to +-127 (`gpt_image_edit_tpu.models.common.
quantize_rows`). K2 (`ops.kernels.fused_quant`) writes this format and
`models.common` reads it."""

from __future__ import annotations

import torch


def quantize_rows(x: torch.Tensor):
    """Dynamic per-row int8 activation quantization: (qx int8, scale f32 (..., 1))."""
    xf = x.float()
    s_x = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-8)
    qx = torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8)
    return qx, s_x
