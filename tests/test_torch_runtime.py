"""Port parity: `UnivaRuntime` (tiny) against the JAX runtime on the same
weights: the edit's conditioning (`_prep_edit`), then both pipelines on
that conditioning with the same initial noise; and the port's `edit` and CLI
end to end on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gpt_image_edit_tpu.pipeline.kontext import postprocess_to_uint8 as jpost
from gpt_image_edit_tpu.serve.runtime import UnivaRuntime as JRuntime
from gpt_image_edit_tpu_torch.pipeline import postprocess_to_uint8
from gpt_image_edit_tpu_torch.serve import cli
from gpt_image_edit_tpu_torch.serve.runtime import UnivaRuntime
from gpt_image_edit_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


def _img(seed, h=40, w=56):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def runtimes():
    """The JAX tiny runtime and the port's, carrying the JAX weights."""
    jrt = JRuntime(tiny=True)
    rt = UnivaRuntime(tiny=True, device="cpu")
    rt.qwen_params = from_jax(jax.tree_util.tree_map(np.asarray, jrt.qwen_params), device="cpu")
    rt.pipe.flux_params = from_jax(jax.tree_util.tree_map(np.asarray, jrt.pipe.flux_params),
                                   device="cpu")
    rt.pipe.vae_params = from_jax(jax.tree_util.tree_map(np.asarray, jrt.pipe.vae_params),
                                  device="cpu")
    assert rt.pipe.vae_params["encoder"]["conv_in"]["kernel"].dtype == torch.bfloat16
    return jrt, rt


@pytest.mark.parametrize("n_images", [1, 2])
def test_prep_edit_matches_jax(runtimes, n_images):
    jrt, rt = runtimes
    images = [_img(i, 40 + 8 * i, 56) for i in range(n_images)]
    image = images if n_images > 1 else images[0]
    prep = rt._prep_edit("make the sky dramatic", image, seed=3)
    jprep = jrt._prep_edit("make the sky dramatic", image, seed=3)
    mask = prep["txt_pad_mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jprep["txt_pad_mask"]))
    valid = mask[0].astype(bool)
    assert 0 < valid.sum() < valid.size
    # the LVLM embeds (fp32 tiny VLM) on the valid rows; the pad rows differ
    # by design (0 attention in the port, the mean of v in JAX's XLA path)
    np.testing.assert_allclose(_np(prep["embeds"])[:, valid], _np(jprep["embeds"])[:, valid],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(_np(prep["pooled"]), _np(jprep["pooled"]))
    assert (prep["height"], prep["width"]) == (jprep["height"], jprep["width"])
    assert len(prep["conds"]) == len(jprep["conds"]) == n_images
    for c, jc in zip(prep["conds"], jprep["conds"]):
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("true_cfg", [False, True])
def test_pipe_on_the_same_conditioning_matches_jax(runtimes, true_cfg):
    """Both pipelines (bf16 MMDiT, bf16 VAE) on the JAX runtime's
    conditioning and the same initial noise: the uint8 images agree within a
    few counts (bf16 rounds at other places in the two frameworks)."""
    jrt, rt = runtimes
    jprep = jrt._prep_edit("make the sky dramatic", _img(4), seed=0)
    kw = dict(height=jprep["height"], width=jprep["width"], num_inference_steps=3,
              guidance_scale=3.5)
    rng = np.random.default_rng(6)
    lat = rng.standard_normal((1, (kw["height"] // 8) * (kw["width"] // 8), 16)).astype(np.float32)
    req = dict(prompt_embeds=np.asarray(jprep["embeds"].astype(jnp.float32)),
               pooled_prompt_embeds=np.asarray(jprep["pooled"].astype(jnp.float32)),
               image=np.asarray(jprep["conds"][0]), latents=lat,
               txt_pad_mask=np.asarray(jprep["txt_pad_mask"]))
    if true_cfg:
        neg, neg_pooled, neg_mask = jrt._neg_cond("Generate an image.")
        req.update(negative_prompt_embeds=np.asarray(neg.astype(jnp.float32)),
                   negative_pooled_prompt_embeds=np.asarray(neg_pooled.astype(jnp.float32)),
                   neg_txt_pad_mask=np.asarray(neg_mask))
        kw["true_cfg_scale"] = 2.0
    jreq = {k: (jnp.asarray(v).astype(jnp.bfloat16) if v.dtype == np.float32 else jnp.asarray(v))
            for k, v in req.items()}
    treq = {k: torch.from_numpy(np.array(v)) for k, v in req.items()}
    treq = {k: (v.bfloat16() if v.is_floating_point() else v) for k, v in treq.items()}
    ours = postprocess_to_uint8(rt.pipe(**treq, **kw)).astype(int)
    ref = jpost(jrt.pipe(**jreq, **kw)).astype(int)
    assert ours.shape == ref.shape == (1, kw["height"], kw["width"], 3)
    diff = np.abs(ours - ref)
    assert diff.max() <= 8 and diff.mean() < 1.0, (diff.max(), diff.mean())


def test_edit_end_to_end():
    rt = UnivaRuntime(tiny=True, device="cpu", quantize="w8a8-attn")
    assert rt.fcfg.attention_impl == "pallas_int8"
    seen = []
    out = rt.edit("make it blue", _img(7), steps=2, seed=1, step_callback=seen.append)
    again = rt.edit("make it blue", _img(7), steps=2, seed=1)
    assert isinstance(out, Image.Image) and out.size == (32, 32) and seen == [0, 1]
    np.testing.assert_array_equal(np.asarray(out), np.asarray(again))  # seeded
    assert set(rt.last_timings) == {"prefill", "text_encoders", "pipeline", "joint_length"}
    outs = rt.edit("make it blue", _img(7), steps=2, true_cfg_scale=2.0, num_images_per_prompt=2)
    assert len(outs) == 2 and np.any(np.asarray(outs[0]) != np.asarray(outs[1]))


def test_cli_tiny_cpu_writes_an_image(tmp_path, capsys):
    src = tmp_path / "in.png"
    _img(8).save(src)
    dst = tmp_path / "out.png"
    assert cli.main(["--tiny", "--device", "cpu", "--image", str(src), "--prompt", "make it red",
                     "--output", str(dst), "--steps", "2", "--quantize", "w8a8-attn"]) == 0
    assert Image.open(dst).size == (32, 32)
    assert "saved" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="chat"):
        cli.main(["--tiny", "--device", "cpu", "--prompt", "what is it?", "--understand"])


def test_runtime_defaults_to_the_card_and_refuses_later_slices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UnivaRuntime(tiny=True)
    for kw in (dict(model_path="/ckpt"), dict(offload=True), dict(mesh=object()),
               dict(quantize_t5="int8")):
        with pytest.raises(NotImplementedError, match="later slice"):
            UnivaRuntime(tiny=True, device="cpu", **kw)
    with pytest.raises(ValueError, match="quantize"):
        UnivaRuntime(tiny=True, device="cpu", quantize="fp4")
    rt = UnivaRuntime(tiny=True, device="cpu")
    for name in ("edit_batch", "route", "chat", "chat_turn", "answer", "edit_t5_only"):
        with pytest.raises(NotImplementedError, match="later slice"):
            getattr(rt, name)("x")
