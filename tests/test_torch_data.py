"""Port parity: the port's copies of the prompt and image preprocessing
(prompter, fake tokenizer, chat_prep, the VAE and ViT views, rope_index)
give exactly what the JAX package's give."""

import numpy as np
import pytest
import torch
from PIL import Image

from gpt_image_edit_tpu.data import constants as JC
from gpt_image_edit_tpu.data.chat_prep import prepare_chat_inputs as jprepare
from gpt_image_edit_tpu.data.image_processing import preprocess_vae_image as jvae_view
from gpt_image_edit_tpu.data.image_processing import smart_resize as jsmart_resize
from gpt_image_edit_tpu.data.prompter import Qwen2VLPrompter as JPrompter
from gpt_image_edit_tpu.data.tokenizer import FakeTokenizer as JFakeTokenizer
from gpt_image_edit_tpu.models.qwen2p5vl import Qwen2p5VLConfig as JQwenConfig
from gpt_image_edit_tpu.models.qwen2p5vl.rope_index import get_rope_index as jrope_index
from gpt_image_edit_tpu_torch.data import constants as C
from gpt_image_edit_tpu_torch.data.chat_prep import prepare_chat_inputs
from gpt_image_edit_tpu_torch.data.image_processing import preprocess_vae_image, smart_resize
from gpt_image_edit_tpu_torch.data.prompter import Qwen2VLPrompter
from gpt_image_edit_tpu_torch.data.tokenizer import FakeTokenizer, load_tokenizer
from gpt_image_edit_tpu_torch.models.qwen2p5vl import Qwen2p5VLConfig
from gpt_image_edit_tpu_torch.models.qwen2p5vl.rope_index import get_rope_index

torch.set_num_threads(2)


def _img(seed, h, w):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


CONVERSATIONS = [
    [{"from": "user", "value": "<image>make the sky dramatic"}],
    [{"from": "system", "value": "be brief"}, {"from": "user", "value": "Generate an image."}],
    [{"from": "user", "value": "<image><image>swap  the two  objects"},
     {"from": "assistant", "value": "ok"}, {"from": "user", "value": "again"}],
]


def test_constants_are_the_same():
    for name in dir(JC):
        if name.isupper():
            assert getattr(C, name) == getattr(JC, name), name


@pytest.mark.parametrize("i", range(len(CONVERSATIONS)))
def test_prompter_and_tokenizer_ids(i):
    conv = CONVERSATIONS[i]
    prompt = Qwen2VLPrompter()(conv)
    assert prompt == JPrompter()(conv)
    assert Qwen2VLPrompter()(conv, add_generation_prompt=False) == JPrompter()(
        conv, add_generation_prompt=False)
    text = prompt.replace("<image>", "<|vision_start|><|image_pad|><|image_pad|><|vision_end|>")
    assert FakeTokenizer().encode(text) == JFakeTokenizer().encode(text)
    assert isinstance(load_tokenizer("fake"), FakeTokenizer)


def test_tokenizer_call_pads_and_truncates():
    texts = ["a photo of a cat", "", "one two three four five six seven eight nine ten"]
    for kw in (dict(padding="max_length", max_length=8, truncation=True), dict()):
        ours, ref = FakeTokenizer()(texts, **kw), JFakeTokenizer()(texts, **kw)
        for key in ("input_ids", "attention_mask"):
            np.testing.assert_array_equal(ours[key], ref[key])
    # the fake ids run past the T5 (32,128) and CLIP (49,408) vocabularies
    assert max(FakeTokenizer()(texts)["input_ids"].max(), 0) > 49408


@pytest.mark.parametrize("i", range(len(CONVERSATIONS)))
def test_prepare_chat_inputs_matches_jax(i):
    conv = CONVERSATIONS[i]
    n_img = sum(c["value"].count("<image>") for c in conv)
    images = [_img(10 + j, 40 + 9 * j, 64 - 5 * j) for j in range(n_img)]
    kw = dict(vit_pixels=3136, gen_trigger=i != 1)
    ours, deltas = prepare_chat_inputs(Qwen2VLPrompter(), FakeTokenizer(), Qwen2p5VLConfig.tiny(),
                                       conv, images, **kw)
    ref, jdeltas = jprepare(JPrompter(), JFakeTokenizer(), JQwenConfig.tiny(), conv, images, **kw)
    np.testing.assert_array_equal(deltas, jdeltas)
    assert set(ours) == set(ref)
    for key in ("input_ids", "position_ids", "attention_mask"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert ours["input_ids"].shape[1] % 128 == 0  # left-padded to a multiple of 128
    if n_img:
        np.testing.assert_array_equal(ours["pixel_patches"].numpy(), np.asarray(ref["pixel_patches"]))
        for field in ("window_order", "inverse_order", "seg_full", "seg_window", "rope_cos",
                      "rope_sin"):
            np.testing.assert_array_equal(getattr(ours["vision_aux"], field),
                                          getattr(ref["vision_aux"], field), err_msg=field)


@pytest.mark.parametrize("size", [(1024, 1024), (832, 1248), (37, 91)])
def test_image_views_match_jax(size):
    h, w = size
    img = _img(3, 97, 61)
    np.testing.assert_array_equal(preprocess_vae_image(img, h, w), jvae_view(img, h, w))
    assert smart_resize(h, w, 28, 3136, 200704) == jsmart_resize(h, w, 28, 3136, 200704)


def test_rope_index_matches_jax():
    """Text-only, an image, and the trailing <|vision_start|> that announces
    the image to be generated (it has no pads after it)."""
    cfg = Qwen2p5VLConfig.tiny()
    ids = np.array([[5, 6, cfg.vision_start_token_id] + [cfg.image_token_id] * 4
                    + [cfg.vision_end_token_id, 7, 8, cfg.vision_start_token_id]])
    attn = np.ones_like(ids)
    attn[0, :1] = 0
    grid = np.array([[1, 4, 4]])
    for g in (grid, None):
        out = get_rope_index(ids, g, attn, spatial_merge_size=2)
        ref = jrope_index(ids, g, attn, spatial_merge_size=2)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
