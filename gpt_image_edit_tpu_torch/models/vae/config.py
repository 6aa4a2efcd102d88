"""FLUX AutoencoderKL configuration.

A copy of `gpt_image_edit_tpu.models.vae.config.VaeConfig`, field for field:
the diffusers AutoencoderKL of the FLUX checkpoint's `vae/` subfolder.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 16
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.3611
    shift_factor: float = 0.1159
    # encode returns the distribution mean ("argmax" mode), the only mode
    # the pipeline uses
    use_quant_conv: bool = False  # FLUX VAE has no quant/post-quant convs

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.block_out_channels) - 1)  # 3 stride-2 stages -> 8

    @classmethod
    def tiny(cls) -> "VaeConfig":
        return cls(block_out_channels=(16, 32, 32), layers_per_block=1, norm_num_groups=8, latent_channels=4)
