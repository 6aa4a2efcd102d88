"""The chat-prompt preprocessing path (a copy of
`gpt_image_edit_tpu.data.chat_prep.prepare_chat_inputs`).

ChatML render -> <image> -> begin + N pads + end expansion -> tokenize ->
left-pad to a multiple of 128 -> M-RoPE position ids, plus the ViT patch
tensors and their per-grid precompute when images are present.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from gpt_image_edit_tpu_torch.data import constants as C
from gpt_image_edit_tpu_torch.data.image_processing import preprocess_vit_patches
from gpt_image_edit_tpu_torch.models.qwen2p5vl.rope_index import get_rope_index
from gpt_image_edit_tpu_torch.models.qwen2p5vl.vision import vision_precompute

PAD_MULTIPLE = 128  # prompts are left-padded to a multiple of this


def prepare_chat_inputs(prompter, tokenizer, cfg, conversation: List[dict], images: List, *,
                        vit_pixels: int, gen_trigger: bool = False) -> Tuple[dict, np.ndarray]:
    """Returns (model_kwargs, rope_deltas). model_kwargs: input_ids,
    position_ids and attention_mask as CPU tensors (+ pixel_patches and
    vision_aux when images are present), the kwargs of
    `models.qwen2p5vl.apply`."""
    prompt = prompter(conversation, add_generation_prompt=True)
    if gen_trigger:
        prompt += C.SPECIAL_TOKENS["image_begin_token"]

    patches, grids = [], []
    for img in images:
        flat, grid = preprocess_vit_patches(
            img, patch_size=cfg.vision.patch_size, merge_size=cfg.vision.spatial_merge_size,
            temporal_patch_size=cfg.vision.temporal_patch_size, min_pixels=vit_pixels,
            max_pixels=vit_pixels)
        patches.append(flat)
        grids.append(grid)
        n = int(np.prod(grid)) // cfg.vision.merge_unit
        expansion = (C.SPECIAL_TOKENS["image_begin_token"] + C.SPECIAL_TOKENS["image_token"] * n
                     + C.SPECIAL_TOKENS["image_end_token"])
        prompt = prompt.replace("<image>", expansion, 1)
    if "<image>" in prompt:
        raise ValueError("more <image> placeholders than images")

    ids = tokenizer.encode(prompt)
    pad_to = -(-len(ids) // PAD_MULTIPLE) * PAD_MULTIPLE
    pad_id = getattr(tokenizer, "pad_token_id", 151643) or 151643
    input_ids = np.full((1, pad_to), pad_id, dtype=np.int64)
    attn = np.zeros((1, pad_to), dtype=np.int64)
    input_ids[0, pad_to - len(ids):] = ids
    attn[0, pad_to - len(ids):] = 1
    grid_thw = np.asarray(grids, dtype=np.int64) if grids else None
    pos, deltas = get_rope_index(
        input_ids, grid_thw, attn, spatial_merge_size=cfg.vision.spatial_merge_size,
        image_token_id=cfg.image_token_id, video_token_id=cfg.video_token_id,
        vision_start_token_id=cfg.vision_start_token_id)
    kwargs = dict(input_ids=torch.from_numpy(input_ids), position_ids=torch.from_numpy(pos),
                  attention_mask=torch.from_numpy(attn))
    if patches:
        kwargs["pixel_patches"] = torch.from_numpy(np.concatenate(patches, 0))
        kwargs["vision_aux"] = vision_precompute(grid_thw, cfg.vision)
    return kwargs, deltas
