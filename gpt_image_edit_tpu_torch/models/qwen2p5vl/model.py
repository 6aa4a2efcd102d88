"""UniVA Qwen2.5-VL composition: ViT -> token scatter -> LM -> MLP2 projector.

Counterpart of `gpt_image_edit_tpu.models.qwen2p5vl.model` for the output
mode "denoise_embeds", the projected prompt embeddings FLUX is conditioned
on. The masked scatter of image embeddings into the token stream is a
cumsum-gather, as in the JAX package. The "lvlm" logits, the KV-cache
generation and the raw-ViT blending options (off in every shipped config)
are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gpt_image_edit_tpu_torch.models.common import Params, linear, linear_init
from gpt_image_edit_tpu_torch.models.qwen2p5vl import language, vision
from gpt_image_edit_tpu_torch.models.qwen2p5vl.config import Qwen2p5VLConfig
from gpt_image_edit_tpu_torch.models.qwen2p5vl.vision import VisionAux


def init(cfg: Qwen2p5VLConfig, *, generator: torch.Generator, device,
         dtype=torch.float32) -> Params:
    """A random param tree in the JAX layout, made on `device` in `dtype`."""
    hidden_mid = cfg.projector_out * 3  # MLP2: in -> 3 * out -> out
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "visual": vision.init(cfg.vision, **kw),
        "lm": language.init(cfg.text, **kw),
        "projector": {
            "fc1": linear_init(generator, cfg.projector_in, hidden_mid, device=device, dtype=dtype),
            "fc2": linear_init(generator, hidden_mid, cfg.projector_out, device=device, dtype=dtype),
        },
    }


def scatter_image_embeds(inputs_embeds: torch.Tensor, image_embeds: torch.Tensor,
                         image_token_mask: torch.Tensor) -> torch.Tensor:
    """Replace the rows at image-token positions with ViT outputs: the k-th
    True position in row-major order receives image_embeds[k]."""
    b, s, d = inputs_embeds.shape
    idx = torch.cumsum(image_token_mask.reshape(-1).long(), 0) - 1
    idx = idx.clamp(0, image_embeds.shape[0] - 1)
    gathered = image_embeds[idx].reshape(b, s, d).to(inputs_embeds.dtype)
    return torch.where(image_token_mask[..., None], gathered, inputs_embeds)


def denoise_projector(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """MLP2: Linear -> SiLU -> Linear."""
    return linear(params["fc2"], F.silu(linear(params["fc1"], hidden)))


def apply(params: Params, cfg: Qwen2p5VLConfig, *, input_ids: torch.Tensor,
          position_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None,
          pixel_patches: Optional[torch.Tensor] = None, vision_aux: Optional[VisionAux] = None,
          image_embeds: Optional[torch.Tensor] = None,
          output_type: str = "denoise_embeds") -> torch.Tensor:
    """Projected prompt embeds (B, S, projector_out)."""
    if output_type != "denoise_embeds" or cfg.shortcut_image_embeds:
        raise NotImplementedError("the port has output_type='denoise_embeds' without "
                                  "shortcut_image_embeds")
    embeds = language.embed(params["lm"], input_ids)
    if pixel_patches is not None:
        if vision_aux is None:
            raise ValueError("pixel_patches need vision_aux")
        image_embeds = vision.apply(params["visual"], cfg.vision,
                                    pixel_patches.to(embeds.dtype), vision_aux)
    if image_embeds is not None:
        embeds = scatter_image_embeds(embeds, image_embeds, input_ids == cfg.image_token_id)
    hidden = language.trunk(params["lm"], cfg.text, embeds, position_ids,
                            pad_mask=attention_mask)
    return denoise_projector(params["projector"], hidden)
