"""FLUX.1 (dev / Kontext-dev) MMDiT configuration.

A copy of `gpt_image_edit_tpu.models.flux.config.FluxConfig`, field for
field, so one config value means the same model in both packages: 19
dual-stream + 38 single-stream blocks, 24 heads x 128, guidance-distilled.

The port reads the model widths, `rope_dtype`, `attention_impl` and
`fuse_mod_quant`. The fields that steer the JAX compiler (`scan_blocks`,
`scan_unroll`) have no meaning under eager PyTorch: the port runs the blocks
as a Python loop either way, which computes the same thing. `remat`
(training) belongs to a path the port does not have yet, and so do the
attention routes other than "auto", "pallas_qk8" and "pallas_int8";
`models.flux.model.apply` refuses a config that asks for them.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    out_channels: int = 64
    num_layers: int = 19            # dual-stream (MMDiT) blocks
    num_single_layers: int = 38     # single-stream blocks
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096   # text conditioning width
    pooled_projection_dim: int = 768  # CLIP pooled width
    guidance_embeds: bool = True
    axes_dims_rope: Tuple[int, int, int] = (16, 56, 56)
    rope_theta: float = 10000.0
    mlp_ratio: float = 4.0
    time_embed_dim: int = 256
    # gradient checkpointing of each block (training only)
    remat: bool = False
    remat_policy: str = "nothing"
    # attention dispatch: "auto" = K1, the bf16 flash kernel;
    # "pallas_qk8" = K3, int8 q k^T + bf16 p v (W8A8 serving, the JAX
    # runtime's --quantize w8a8-qk8); "pallas_int8" = K4, int8 q k^T and
    # int8 p v (--quantize w8a8-attn). Each launches its CUDA kernel on a
    # CUDA tensor and runs its plain version on a CPU tensor.
    attention_impl: str = "auto"
    # rope rotation dtype: "float32" = reference-faithful (diffusers
    # apply_rotary_emb upcasts); "bfloat16" keeps the rotation + tables in bf16
    rope_dtype: str = "float32"
    # JAX compiler knobs (lax.scan over the stacked blocks); no effect here
    scan_blocks: bool = True
    scan_unroll: int = 1
    # fused ln+modulate+int8-quant block prologue (K2) for W8A8 kernels:
    # "env" reads GIE_FUSE_MOD_QUANT (default on; "0" = off), or "on" |
    # "off" | "interpret". "on" launches K2 on a CUDA tensor and takes its
    # plain version on a CPU tensor; "off" runs the unfused chain and
    # quantizes in the consuming linear. "interpret" (the JAX package's
    # CPU test mode) is accepted so that one config means the same in both
    # packages, and does what "on" does.
    fuse_mod_quant: str = "env"

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def mlp_dim(self) -> int:
        return int(self.inner_dim * self.mlp_ratio)

    @classmethod
    def tiny(cls) -> "FluxConfig":
        """Small config for tests: same topology, toy widths."""
        return cls(
            in_channels=16,
            out_channels=16,
            num_layers=2,
            num_single_layers=3,
            attention_head_dim=32,
            num_attention_heads=4,
            joint_attention_dim=64,
            pooled_projection_dim=32,
            axes_dims_rope=(8, 12, 12),
        )
