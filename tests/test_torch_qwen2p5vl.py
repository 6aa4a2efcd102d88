"""Port parity: Qwen2.5-VL's prefill half (the ViT with window and full
blocks, the causal + pad GQA LM prefill, the MLP2 projector and
`apply(output_type="denoise_embeds")`) against the JAX package on the same
tiny weights and inputs, fp32 on the CPU.

Prompts are left-padded to a multiple of 128, so the leading pad rows of
the LM prefill see no key. The JAX XLA path gives them the mean of v; K1
(the port's prefill attention) gives them 0. Those rows reach no valid row
(they are masked as keys), so valid rows are compared, and the port's pad
rows are held to 0 at the attention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gpt_image_edit_tpu.data.chat_prep import prepare_chat_inputs as jprepare
from gpt_image_edit_tpu.data.prompter import Qwen2VLPrompter as JPrompter
from gpt_image_edit_tpu.data.tokenizer import FakeTokenizer as JFakeTokenizer
from gpt_image_edit_tpu.models.qwen2p5vl import Qwen2p5VLConfig as JQwenConfig
from gpt_image_edit_tpu.models.qwen2p5vl import apply_qwen as japply
from gpt_image_edit_tpu.models.qwen2p5vl import init_qwen as jinit
from gpt_image_edit_tpu.models.qwen2p5vl import vision as jvision
from gpt_image_edit_tpu.ops.rope import apply_rope_halves as japply_rope_halves
from gpt_image_edit_tpu.ops.rope import mrope_freqs as jmrope_freqs
from gpt_image_edit_tpu_torch.data.chat_prep import prepare_chat_inputs
from gpt_image_edit_tpu_torch.data.prompter import Qwen2VLPrompter
from gpt_image_edit_tpu_torch.data.tokenizer import FakeTokenizer
from gpt_image_edit_tpu_torch.models.qwen2p5vl import Qwen2p5VLConfig, apply_qwen, init_qwen
from gpt_image_edit_tpu_torch.models.qwen2p5vl import language, model as tmodel, vision
from gpt_image_edit_tpu_torch.ops.rope import apply_rope_halves, mrope_freqs
from gpt_image_edit_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)

# fp32 on both sides: matmuls, norms and rope differ only in summation order
# and the last bits of rsqrt/cos/sin, compounded over the tiny stack
TOL = dict(rtol=1e-4, atol=1e-5)


def _img(seed, h, w):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def weights():
    jp = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), JQwenConfig.tiny()))
    return jp, from_jax(jp, device="cpu")


def _inputs(images, text="make the sky dramatic"):
    conv = [{"from": "user", "value": "<image>" * len(images) + text}]
    ours, _ = prepare_chat_inputs(Qwen2VLPrompter(), FakeTokenizer(), Qwen2p5VLConfig.tiny(),
                                  conv, images, vit_pixels=3136, gen_trigger=True)
    ref, _ = jprepare(JPrompter(), JFakeTokenizer(), JQwenConfig.tiny(), conv, images,
                      vit_pixels=3136, gen_trigger=True)
    return ours, ref


def test_rope_helpers_match_jax():
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 50, (3, 2, 7))
    cos, sin = mrope_freqs(torch.from_numpy(pos), 12, (2, 2, 2), 1e6)
    jcos, jsin = jmrope_freqs(jnp.asarray(pos), 12, (2, 2, 2), 1e6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), rtol=0, atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), rtol=0, atol=1e-6)
    x = rng.standard_normal((2, 7, 3, 12)).astype(np.float32)
    out = apply_rope_halves(torch.from_numpy(x), cos[:, :, None], sin[:, :, None])
    ref = japply_rope_halves(jnp.asarray(x), jcos[:, :, None], jsin[:, :, None])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("sizes", [[(56, 56)], [(40, 72), (64, 48)]], ids=["one", "two_images"])
def test_vision_tower_matches_jax(weights, sizes):
    """Two blocks (one windowed, one full) and the merger; the windows of
    the 7x7 merged grid are ragged (2x2 cells)."""
    jp, tp = weights
    ours, ref = _inputs([_img(i, h, w) for i, (h, w) in enumerate(sizes)])
    cfg = Qwen2p5VLConfig.tiny()
    out = vision.apply(tp["visual"], cfg.vision, ours["pixel_patches"], ours["vision_aux"])
    jout = jvision.apply(jax.tree_util.tree_map(jnp.asarray, jp["visual"]), JQwenConfig.tiny().vision,
                         ref["pixel_patches"], ref["vision_aux"])
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("n_images", [0, 1])
def test_prefill_matches_jax_on_valid_rows(weights, n_images, monkeypatch):
    jp, tp = weights
    ours, ref = _inputs([_img(5, 48, 64)][:n_images])
    seen = []
    real = language.dot_product_attention

    def recording(q, k, v, **kw):
        out = real(q, k, v, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(language, "dot_product_attention", recording)
    out = apply_qwen(tp, Qwen2p5VLConfig.tiny(), output_type="denoise_embeds", **ours).numpy()
    jout = np.asarray(japply(jax.tree_util.tree_map(jnp.asarray, jp), JQwenConfig.tiny(),
                             output_type="denoise_embeds", **ref))
    valid = ours["attention_mask"].numpy()[0].astype(bool)
    assert 0 < valid.sum() < valid.size  # the prompt is left-padded
    np.testing.assert_allclose(out[:, valid], jout[:, valid], **TOL)
    assert np.isfinite(out).all()
    # every layer's attention gives the pad rows 0 (they see no key)
    assert len(seen) == Qwen2p5VLConfig.tiny().text.num_layers
    for attn in seen:
        assert bool((attn[:, ~torch.from_numpy(valid)] == 0).all())


def test_scatter_image_embeds_is_masked_scatter():
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.standard_normal((2, 6, 4)).astype(np.float32))
    img = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
    mask = torch.tensor([[0, 1, 0, 0, 1, 0], [1, 0, 0, 0, 0, 0]], dtype=torch.bool)
    out = tmodel.scatter_image_embeds(emb, img, mask)
    want = emb.clone()
    want[mask] = img
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_embed_clamps_ids_as_jax_does(weights):
    jp, tp = weights
    ids = np.array([[0, 5, 159999, 160000, 200000]])
    out = language.embed(tp["lm"], torch.from_numpy(ids)).numpy()
    ref = np.asarray(jnp.asarray(jp["lm"]["embed_tokens"])[jnp.asarray(ids)])
    np.testing.assert_array_equal(out, ref)


def test_init_layout_matches_jax(weights):
    """The port's own init builds the JAX tree: same keys, shapes, dtypes."""
    jp, _ = weights
    tp = init_qwen(Qwen2p5VLConfig.tiny(), generator=torch.Generator().manual_seed(0),
                   device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(tp) == shapes(jp)
