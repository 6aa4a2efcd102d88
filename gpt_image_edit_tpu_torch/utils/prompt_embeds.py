"""FLUX text conditioning: the T5-XXL sequence embeds and the CLIP-L pooled row.

Counterpart of `gpt_image_edit_tpu.utils.prompt_embeds.FluxTextEncoders` in
its synthetic mode: the fake tokenizer for both encoders and seeded random
bf16 weights built on the device (`utils.synthetic`). Loading the encoders from a
FLUX checkpoint comes with checkpoint loading (M8), a later slice.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from gpt_image_edit_tpu_torch.data.tokenizer import FakeTokenizer
from gpt_image_edit_tpu_torch.models import clip as clip_mod
from gpt_image_edit_tpu_torch.models import t5 as t5_mod


class FluxTextEncoders:
    """Lazy container: each encoder's weights are built on first use, so a
    caller that needs only the CLIP pooled row never builds T5-XXL."""

    def __init__(self, *, device="cuda", seed: int = 5):
        self.clip_cfg = clip_mod.ClipTextConfig()
        self.t5_cfg = t5_mod.T5Config()
        self.device = device
        self.seed = seed
        self._clip = None  # (tokenizer, params)
        self._t5 = None

    @property
    def clip(self):
        if self._clip is None:
            from gpt_image_edit_tpu_torch.utils.synthetic import synthetic_clip

            self._clip = (FakeTokenizer(), synthetic_clip(self.clip_cfg, seed=self.seed,
                                                          device=self.device))
        return self._clip

    @property
    def t5(self):
        if self._t5 is None:
            from gpt_image_edit_tpu_torch.utils.synthetic import synthetic_t5

            self._t5 = (FakeTokenizer(), synthetic_t5(self.t5_cfg, seed=self.seed + 1,
                                                      device=self.device))
        return self._t5

    def _ids(self, tokenizer, prompts: List[str], max_length: int) -> torch.Tensor:
        toks = tokenizer(prompts, padding="max_length", max_length=max_length, truncation=True,
                         return_tensors="np")
        return torch.from_numpy(toks["input_ids"]).to(self.device)

    @torch.inference_mode()
    def encode_clip_pooled(self, prompts: List[str]) -> torch.Tensor:
        """(B, 768) pooled embeds of 77-token prompts."""
        tok, params = self.clip
        _, pooled = clip_mod.apply(params, self.clip_cfg, self._ids(tok, prompts, 77))
        return pooled

    @torch.inference_mode()
    def encode_t5(self, prompts: List[str], max_length: int = 512) -> torch.Tensor:
        """(B, max_length, 4096) sequence embeds."""
        tok, params = self.t5
        return t5_mod.apply(params, self.t5_cfg, self._ids(tok, prompts, max_length))

    def encode_prompt(self, prompts: List[str],
                      max_sequence_length: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t5_embeds, pooled)."""
        return self.encode_t5(prompts, max_sequence_length), self.encode_clip_pooled(prompts)
