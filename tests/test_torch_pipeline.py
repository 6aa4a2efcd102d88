"""Port parity: the whole `KontextPipeline.__call__` (VAE encode -> 4-step
Euler loop -> VAE decode) against the JAX pipeline on the same tiny weights,
reference image, conditioning and initial noise (CPU, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.models.flux import FluxConfig as JFluxConfig
from gpt_image_edit_tpu.models.flux import init_flux as jinit_flux
from gpt_image_edit_tpu.models.vae import VaeConfig as JVaeConfig
from gpt_image_edit_tpu.models.vae import init_vae as jinit_vae
from gpt_image_edit_tpu.pipeline.kontext import KontextPipeline as JKontextPipeline
from gpt_image_edit_tpu.pipeline.kontext import postprocess_to_uint8 as jpost
from gpt_image_edit_tpu.pipeline.scheduler import flow_sigmas as jflow_sigmas
from gpt_image_edit_tpu_torch.models.flux import FluxConfig
from gpt_image_edit_tpu_torch.models.vae import VaeConfig
from gpt_image_edit_tpu_torch.pipeline import (
    KontextPipeline,
    flow_sigmas,
    pick_kontext_resolution,
    postprocess_to_uint8,
)
from gpt_image_edit_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)

H = W = 32  # VaeConfig.tiny downscales by 4: an 8x8 latent, 16 target tokens


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def pipes():
    fp = jax.tree_util.tree_map(np.asarray, jinit_flux(jax.random.key(0), JFluxConfig.tiny()))
    vp = jax.tree_util.tree_map(np.asarray, jinit_vae(jax.random.key(1), JVaeConfig.tiny()))
    jpipe = JKontextPipeline(jax.tree_util.tree_map(jnp.asarray, fp), JFluxConfig.tiny(),
                             jax.tree_util.tree_map(jnp.asarray, vp), JVaeConfig.tiny())
    tpipe = KontextPipeline(from_jax(fp, device="cpu"), FluxConfig.tiny(),
                            from_jax(vp, device="cpu"), VaeConfig.tiny(), device="cpu")
    return jpipe, tpipe


def _request(true_cfg):
    rng = np.random.default_rng(5)
    fc = FluxConfig.tiny()
    req = dict(
        prompt_embeds=rng.standard_normal((1, 6, fc.joint_attention_dim)).astype(np.float32),
        pooled_prompt_embeds=rng.standard_normal((1, fc.pooled_projection_dim)).astype(np.float32),
        image=rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32),
        latents=rng.standard_normal((1, 16, fc.in_channels)).astype(np.float32),
        txt_pad_mask=np.array([[1, 1, 1, 1, 0, 0]], bool),
    )
    if true_cfg:
        req.update(
            negative_prompt_embeds=rng.standard_normal((1, 4, fc.joint_attention_dim)).astype(np.float32),
            negative_pooled_prompt_embeds=rng.standard_normal((1, fc.pooled_projection_dim)).astype(np.float32),
            neg_txt_pad_mask=np.array([[1, 1, 1, 0]], bool),
        )
    return req


@pytest.mark.parametrize("true_cfg", [False, True])
def test_call_matches_jax(pipes, true_cfg):
    jpipe, tpipe = pipes
    req = _request(true_cfg)
    common = dict(height=H, width=W, num_inference_steps=4,
                  true_cfg_scale=2.0 if true_cfg else 1.0)
    jreq = {k: jnp.asarray(v) for k, v in req.items()}
    treq = {k: torch.from_numpy(v) for k, v in req.items()}
    steps = []
    j_lat = np.asarray(jpipe(**jreq, **common, output_type="latent"))
    t_lat = tpipe(**treq, **common, output_type="latent", step_callback=steps.append).numpy()
    assert steps == [0, 1, 2, 3]
    # fp32 throughout; 4 Euler steps through the MMDiT and a VAE encode
    assert _rel_l2(t_lat, j_lat) < 1e-4
    j_img = jpost(jpipe(**jreq, **common))
    t_img = postprocess_to_uint8(tpipe(**treq, **common))
    assert t_img.shape == j_img.shape == (1, H, W, 3) and t_img.dtype == np.uint8
    # uint8 rounding may flip a value sitting on a rounding boundary
    assert np.abs(t_img.astype(int) - j_img.astype(int)).max() <= 1


def test_noise_from_generator(pipes):
    _, tpipe = pipes
    req = _request(False)
    del req["latents"]
    treq = {k: torch.from_numpy(v) for k, v in req.items()}
    kw = dict(height=H, width=W, num_inference_steps=2, output_type="latent")
    a = tpipe(**treq, **kw, generator=torch.Generator().manual_seed(7))
    b = tpipe(**treq, **kw, generator=torch.Generator().manual_seed(7))
    c = tpipe(**treq, **kw, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_num_images_per_prompt_tiles_the_request(pipes):
    _, tpipe = pipes
    treq = {k: torch.from_numpy(v) for k, v in _request(False).items()}
    kw = dict(height=H, width=W, num_inference_steps=2, output_type="latent")
    one = tpipe(**treq, **kw)
    two = tpipe(**treq, **kw, num_images_per_prompt=2)
    assert two.shape == (2,) + tuple(one.shape[1:])
    # same noise and conditioning in both rows; batched matmuls may sum in
    # another order than the single-row call
    torch.testing.assert_close(two[0], one[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(two[1], one[0], rtol=1e-5, atol=1e-5)


def test_schedule_and_buckets_match_jax():
    from gpt_image_edit_tpu.pipeline.kontext import pick_kontext_resolution as jpick

    for n, s in [(28, 4096), (4, 16), (20, 4056)]:
        np.testing.assert_array_equal(flow_sigmas(n, s), jflow_sigmas(n, s))
    for w, h in [(1024, 1024), (1248, 832), (640, 1600), (3000, 400)]:
        assert pick_kontext_resolution(w, h) == jpick(w, h)


def test_multi_reference_edit_matches_jax(pipes):
    """Two conditioning images through encode_references: each packed after
    the target tokens with rope modality ids 1 and 2."""
    jpipe, tpipe = pipes
    req = _request(False)
    second = np.random.default_rng(6).uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    common = dict(height=H, width=W, num_inference_steps=3, output_type="latent")
    jreq = {k: jnp.asarray(v) for k, v in req.items()}
    treq = {k: torch.from_numpy(v) for k, v in req.items()}
    jreq["image"] = [jreq["image"], jnp.asarray(second)]
    treq["image"] = [treq["image"], torch.from_numpy(second)]
    _, j_ids = jpipe.encode_references(jreq["image"])
    _, t_ids = tpipe.encode_references(treq["image"])
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert set(np.unique(t_ids.numpy()[:, 0])) == {1.0, 2.0}
    j_lat = np.asarray(jpipe(**jreq, **common))
    t_lat = tpipe(**treq, **common).numpy()
    # fp32 throughout, as test_call_matches_jax
    assert _rel_l2(t_lat, j_lat) < 1e-4


def test_num_images_per_prompt_matches_jax(pipes):
    jpipe, tpipe = pipes
    req = _request(True)
    common = dict(height=H, width=W, num_inference_steps=2, output_type="latent",
                  true_cfg_scale=2.0, num_images_per_prompt=2)
    j_lat = np.asarray(jpipe(**{k: jnp.asarray(v) for k, v in req.items()}, **common))
    t_lat = tpipe(**{k: torch.from_numpy(v) for k, v in req.items()}, **common).numpy()
    assert t_lat.shape == j_lat.shape == (2, 16, FluxConfig.tiny().in_channels)
    assert _rel_l2(t_lat, j_lat) < 1e-4


@pytest.mark.parametrize("impl", ["auto", "pallas_qk8"])
def test_w8a8_call_matches_jax(pipes, impl):
    """The tiny pipeline with its FLUX quantized W8A8 by the port
    (`utils.quantize`) and by the JAX package, K2 on (JAX: interpret) and
    either attention route."""
    import dataclasses

    from gpt_image_edit_tpu.utils.quantize import quantize_params as jquantize_params
    from gpt_image_edit_tpu_torch.utils.quantize import quantize_params

    jpipe, tpipe = pipes
    jcfg = dataclasses.replace(JFluxConfig.tiny(), attention_impl=impl, fuse_mod_quant="interpret")
    tcfg = dataclasses.replace(FluxConfig.tiny(), attention_impl=impl, fuse_mod_quant="on")
    jq = JKontextPipeline(jquantize_params(jpipe.flux_params, min_size=1024, mode="w8a8"), jcfg,
                          jpipe.vae_params, JVaeConfig.tiny())
    # a tree of its own: quantize_params works in place
    fresh = from_jax(jax.tree_util.tree_map(np.asarray, jpipe.flux_params), device="cpu")
    tq = KontextPipeline(quantize_params(fresh, min_size=1024, mode="w8a8"), tcfg,
                         tpipe.vae_params, VaeConfig.tiny(), device="cpu")
    # the tree's first leaf is an int8 dict (x_embedder, 16 x 128): the
    # pipeline's device check reads through it
    assert "q_w8a8" in tq.flux_params["x_embedder"]["kernel"]
    assert "q_w8a8" in tq.flux_params["dual_blocks"]["ff"]["in"]["kernel"]
    req = _request(False)
    common = dict(height=H, width=W, num_inference_steps=4)
    j_lat = np.asarray(jq(**{k: jnp.asarray(v) for k, v in req.items()}, **common,
                          output_type="latent"))
    t_lat = tq(**{k: torch.from_numpy(v) for k, v in req.items()}, **common,
               output_type="latent").numpy()
    # int8 codes on a rounding tie may move by 1 LSB between the two
    # frameworks (last-bit differences in norms, rope and gelu); 4 steps of
    # 5 quantized blocks carry that through: the fused-prologue bar
    assert _rel_l2(t_lat, j_lat) < 5e-3
