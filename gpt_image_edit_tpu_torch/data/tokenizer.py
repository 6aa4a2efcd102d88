"""The fake tokenizer (a copy of `gpt_image_edit_tpu.data.tokenizer`'s
`FakeTokenizer` and `load_tokenizer("fake")`).

A deterministic hash tokenizer with the real Qwen special-token ids: text
tokens get crc32(token) % 150000 + 256, so the whole prompt protocol (ChatML,
<image> expansion, left padding, M-RoPE ids) runs without a tokenizer file.
Its ids reach 150,255, beyond the T5 and CLIP vocabularies; the encoders
clamp them into range, as the JAX package's gathers do."""

from __future__ import annotations

import re
import zlib
from typing import List

import numpy as np

from gpt_image_edit_tpu_torch.data import constants as C

_SPECIAL = {
    "<|image_pad|>": C.IMAGE_TOKEN_ID,
    "<|vision_start|>": C.VISION_START_ID,
    "<|vision_end|>": C.VISION_END_ID,
    "<|im_start|>": C.IM_START_ID,
    "<|im_end|>": C.IM_END_ID,
}
_SPECIAL_RE = re.compile("(" + "|".join(re.escape(t) for t in _SPECIAL) + ")")


class FakeTokenizer:
    """Whitespace/hash tokenizer with real Qwen special-token ids."""

    vocab_size = 152064
    eos_token = "<|im_end|>"
    eos_token_id = C.IM_END_ID
    pad_token_id = 151643  # <|endoftext|>

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for chunk in _SPECIAL_RE.split(text):
            if not chunk:
                continue
            if chunk in _SPECIAL:
                ids.append(_SPECIAL[chunk])
            else:
                ids.extend(zlib.crc32(tok.encode()) % 150000 + 256
                           for tok in chunk.split(" ") if tok)
        return ids

    def __call__(self, texts, padding=None, max_length=None, truncation=False,
                 return_tensors="np"):
        """Tokenizer-call shim (padding/truncation to max_length), so the
        fake tokenizer stands in for the CLIP and T5 tokenizers."""
        if isinstance(texts, str):
            texts = [texts]
        rows = [self.encode(t) for t in texts]
        if truncation and max_length is not None:
            rows = [r[:max_length] for r in rows]
        width = max_length if padding == "max_length" and max_length else max(
            (len(r) for r in rows), default=1)
        ids = np.full((len(rows), width), self.pad_token_id, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r[:width]
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def load_tokenizer(path_or_fake: str):
    """The fake tokenizer; real tokenizers come with checkpoints (not ported)."""
    if path_or_fake in ("fake", "", None):
        return FakeTokenizer()
    raise NotImplementedError("tokenizers from a checkpoint come with checkpoint loading (M8), "
                              "a later slice of the port; use 'fake'")
