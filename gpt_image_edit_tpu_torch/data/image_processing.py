"""Host-side image preprocessing (numpy/PIL) for both image views: a copy of
`gpt_image_edit_tpu.data.image_processing`'s serving half.

1. the ViT view: Qwen smart_resize, CLIP normalization, patch flattening in
   merge-block order (HF Qwen2VLImageProcessor semantics);
2. the VAE view: resized to the generation resolution, scaled to [-1, 1].
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from PIL import Image

from gpt_image_edit_tpu_torch.data.constants import OPENAI_CLIP_MEAN, OPENAI_CLIP_STD


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """Qwen2-VL resize rule: dims to multiples of `factor`, area clamped to
    [min_pixels, max_pixels], aspect preserved."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = round(height / factor) * factor
    w_bar = round(width / factor) * factor
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = math.floor(height / beta / factor) * factor
        w_bar = math.floor(width / beta / factor) * factor
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_vit_patches(image: Image.Image, *, patch_size: int = 14, merge_size: int = 2,
                           temporal_patch_size: int = 2, min_pixels: int = 200704,
                           max_pixels: int = 200704) -> Tuple[np.ndarray, Tuple[int, int, int]]:
    """PIL image -> (flattened patches (S, C*t*p*p), grid_thw (1, h, w)):
    bicubic resize, CLIP normalize, temporal tile x2, merge-block-ordered
    patch flattening."""
    rh, rw = smart_resize(image.height, image.width, factor=patch_size * merge_size,
                          min_pixels=min_pixels, max_pixels=max_pixels)
    img = image.convert("RGB").resize((rw, rh), Image.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    arr = (arr - np.asarray(OPENAI_CLIP_MEAN)) / np.asarray(OPENAI_CLIP_STD)
    patches = np.tile(arr.transpose(2, 0, 1)[None], (temporal_patch_size, 1, 1, 1))  # (T, C, H, W)
    grid_t, grid_h, grid_w = 1, rh // patch_size, rw // patch_size
    patches = patches.reshape(grid_t, temporal_patch_size, 3, grid_h // merge_size, merge_size,
                              patch_size, grid_w // merge_size, merge_size, patch_size)
    patches = patches.transpose(0, 3, 6, 4, 7, 2, 1, 5, 8)
    flat = patches.reshape(grid_t * grid_h * grid_w,
                           3 * temporal_patch_size * patch_size * patch_size).astype(np.float32)
    return flat, (grid_t, grid_h, grid_w)


def preprocess_vae_image(image: Image.Image, height: int, width: int) -> np.ndarray:
    """PIL -> (H, W, 3) float32 in [-1, 1], resized to the target resolution."""
    img = image.convert("RGB").resize((width, height), Image.BICUBIC)
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return arr * 2.0 - 1.0
