"""Host-side M-RoPE position-id computation (numpy), a copy of
`gpt_image_edit_tpu.models.qwen2p5vl.rope_index`.

Port of the reference's modified `get_rope_index`
(ref:univa/models/qwen2p5vl/modeling_univa_qwen2p5vl.py:139-318), including
the UniVA fix at :222-225 that skips a trailing <|vision_start|> token which
precedes a *to-be-generated* image (it has no real image tokens after it).

This runs on the host per batch (token streams are host data anyway), so the
model only sees a dense (3, B, S) int array.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def get_rope_index(
    input_ids: np.ndarray,              # (B, S)
    image_grid_thw: Optional[np.ndarray],  # (num_images, 3)
    attention_mask: Optional[np.ndarray],  # (B, S) 1 = real token
    *,
    spatial_merge_size: int = 2,
    image_token_id: int = 151655,
    video_token_id: int = 151656,
    vision_start_token_id: int = 151652,
    tokens_per_second: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (position_ids (3, B, S), mrope_deltas (B, 1))."""
    input_ids = np.asarray(input_ids)
    b, s = input_ids.shape
    if attention_mask is None:
        attention_mask = np.ones_like(input_ids)

    if image_grid_thw is None or len(image_grid_thw) == 0:
        # pure text: positions count real tokens (ref :300-305)
        pos = np.cumsum(attention_mask, axis=-1) - 1
        pos = np.where(attention_mask == 0, 1, pos)
        position_ids = np.broadcast_to(pos[None], (3, b, s)).astype(np.int64)
        deltas = (position_ids.max(axis=0).max(axis=-1, keepdims=True) + 1 - s).astype(
            np.int64
        )
        return position_ids, deltas

    position_ids = np.ones((3, b, s), dtype=np.int64)
    deltas = np.zeros((b, 1), dtype=np.int64)
    image_index = 0
    for i in range(b):
        ids = input_ids[i][attention_mask[i] == 1]
        n = len(ids)
        vis_starts = np.where(ids == vision_start_token_id)[0]
        # UniVA fix: a vision_start at the very end announces the image to be
        # generated and has no pads after it -> skip (ref :222-225)
        vis_starts = vis_starts[vis_starts + 1 < n]
        vision_tokens = ids[vis_starts + 1]
        num_images = int((vision_tokens == image_token_id).sum())

        parts = []
        st = 0
        tokens = ids.tolist()
        for _ in range(num_images):
            ed = tokens.index(image_token_id, st)
            t, h, w = image_grid_thw[image_index]
            image_index += 1
            gh, gw = h // spatial_merge_size, w // spatial_merge_size
            text_len = ed - st
            st_idx = parts[-1].max() + 1 if parts else 0
            parts.append(np.tile(np.arange(text_len) + st_idx, (3, 1)))
            t_idx = np.repeat(np.arange(t) * 0, gh * gw)  # images: t stride 0
            h_idx = np.tile(np.repeat(np.arange(gh), gw), t)
            w_idx = np.tile(np.tile(np.arange(gw), gh), t)
            parts.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + t * gh * gw
        if st < n:
            st_idx = parts[-1].max() + 1 if parts else 0
            parts.append(np.tile(np.arange(n - st) + st_idx, (3, 1)))

        pos = np.concatenate(parts, axis=1)
        position_ids[:, i, attention_mask[i] == 1] = pos
        deltas[i, 0] = pos.max() + 1 - s
    return position_ids, deltas
