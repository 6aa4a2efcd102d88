"""Qwen2.5-VL configuration (vision tower + LM trunk + UniVA extensions), a
copy of `gpt_image_edit_tpu.models.qwen2p5vl.config`, field for field.

Parity target: the HF Qwen2.5-VL-7B-Instruct config wrapped by
UnivaQwen2p5VLConfig (ref:univa/models/qwen2p5vl/configuration_univa_qwen2p5vl.py:14-31),
whose only additions are the denoise-tower subconfig and shortcut flags.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    window_size: int = 112
    out_hidden_size: int = 3584
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    tokens_per_second: int = 2
    rms_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def patch_dim(self) -> int:
        return self.in_channels * self.temporal_patch_size * self.patch_size ** 2

    @property
    def merge_unit(self) -> int:
        return self.spatial_merge_size ** 2


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 152064
    hidden_size: int = 3584
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    intermediate_size: int = 18944
    rms_eps: float = 1e-6
    rope_theta: float = 1000000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    tie_word_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class Qwen2p5VLConfig:
    vision: VisionConfig = VisionConfig()
    text: TextConfig = TextConfig()
    # special token ids (Qwen2.5-VL tokenizer)
    image_token_id: int = 151655      # <|image_pad|>
    video_token_id: int = 151656
    vision_start_token_id: int = 151652  # <|vision_start|>
    vision_end_token_id: int = 151653    # <|vision_end|>
    # UniVA extensions (ref:configuration_univa_qwen2p5vl.py:14-31)
    shortcut_image_embeds: bool = False
    shortcut_image_embeds_scale: float = 0.5
    # denoise projector: LVLM hidden -> FLUX joint_attention_dim
    # (ref:univa/models/modeling_univa_denoise_tower.py:31-47)
    projector_in: int = 3584
    projector_out: int = 4096

    @classmethod
    def tiny(cls) -> "Qwen2p5VLConfig":
        return cls(
            vision=VisionConfig(
                depth=2,
                hidden_size=32,
                intermediate_size=64,
                num_heads=2,
                patch_size=4,
                temporal_patch_size=2,
                spatial_merge_size=2,
                window_size=16,
                out_hidden_size=48,
                fullatt_block_indexes=(1,),
            ),
            text=TextConfig(
                vocab_size=160000,
                hidden_size=48,
                num_layers=2,
                num_heads=4,
                num_kv_heads=2,
                intermediate_size=96,
                mrope_section=(2, 2, 2),  # sums to head_dim//2 = 6
            ),
            projector_in=48,
            projector_out=32,
        )
