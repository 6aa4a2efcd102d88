"""Port parity: FLUX MMDiT `apply` against the JAX model on the same tiny
weights and numpy inputs (CPU; the port's attention runs its plain version)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.models.common import cast_floating
from gpt_image_edit_tpu.models.flux import FluxConfig as JFluxConfig
from gpt_image_edit_tpu.models.flux import apply_flux as japply
from gpt_image_edit_tpu.models.flux import init_flux as jinit
from gpt_image_edit_tpu.ops.packing import latent_image_ids as jids
from gpt_image_edit_tpu_torch.models.flux import FluxConfig, apply_flux, init_flux
from gpt_image_edit_tpu_torch.models.flux.model import timestep_embedding
from gpt_image_edit_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup():
    cfg = JFluxConfig.tiny()
    params = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), cfg))
    rng = np.random.default_rng(1)
    b, s_img, s_txt = 2, 12, 5
    inputs = dict(
        hidden_states=rng.standard_normal((b, s_img, cfg.in_channels)).astype(np.float32),
        encoder_hidden_states=rng.standard_normal((b, s_txt, cfg.joint_attention_dim)).astype(np.float32),
        pooled_projections=rng.standard_normal((b, cfg.pooled_projection_dim)).astype(np.float32),
        timestep=np.array([0.5, 0.25], np.float32),
        img_ids=np.array(jids(3, 4, modality=0)),
        guidance=np.full((b,), 3.5, np.float32),
    )
    pad = np.ones((b, s_txt + s_img), bool)
    pad[0, 3:s_txt] = False
    pad[1, 4:s_txt] = False
    return cfg, params, inputs, pad


def _run(cfg, params, inputs, pad, dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jp = cast_floating(jax.tree_util.tree_map(jnp.asarray, params), jdt)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jin["hidden_states"] = jin["hidden_states"].astype(jdt)
    ref = japply(jp, cfg, pad_mask=None if pad is None else jnp.asarray(pad), **jin)
    tp = from_jax(params, device="cpu", dtype=dtype)
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    tin["hidden_states"] = tin["hidden_states"].to(dtype)
    out = apply_flux(tp, FluxConfig.tiny(), pad_mask=None if pad is None else torch.from_numpy(pad),
                     **tin)
    assert out.dtype == dtype and out.shape == tuple(ref.shape)
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("with_pad", [False, True])
def test_apply_fp32(setup, with_pad):
    cfg, params, inputs, pad = setup
    out, ref = _run(cfg, params, inputs, pad if with_pad else None, torch.float32)
    # fp32 end to end: only summation order differs
    assert _rel_l2(out, ref) < 1e-5
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("with_pad", [False, True])
def test_apply_bf16(setup, with_pad):
    cfg, params, inputs, pad = setup
    out, ref = _run(cfg, params, inputs, pad if with_pad else None, torch.bfloat16)
    # bf16 rounds at different places in the two frameworks
    assert np.isfinite(out).all()
    assert _rel_l2(out, ref) < 2e-2


def test_pad_mask_hides_masked_text(setup):
    cfg, params, inputs, pad = setup
    tp = from_jax(params, device="cpu")
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    pm = torch.from_numpy(pad)
    a = apply_flux(tp, FluxConfig.tiny(), pad_mask=pm, **tin)
    txt = tin["encoder_hidden_states"].clone()
    txt[1, 4:] += 5.0  # only masked text tokens change
    tin["encoder_hidden_states"] = txt
    b = apply_flux(tp, FluxConfig.tiny(), pad_mask=pm, **tin)
    torch.testing.assert_close(a[1], b[1], rtol=0, atol=1e-6)


def test_rope_bf16_option(setup):
    cfg, params, inputs, pad = setup
    import dataclasses

    jcfg = dataclasses.replace(cfg, rope_dtype="bfloat16")
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    ref = np.asarray(japply(jax.tree_util.tree_map(jnp.asarray, params), jcfg, **jin))
    tcfg = dataclasses.replace(FluxConfig.tiny(), rope_dtype="bfloat16")
    out = apply_flux(from_jax(params, device="cpu"), tcfg,
                     **{k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    # a table entry 1 ulp apart in fp32 may round to neighbouring bf16 values
    assert _rel_l2(out, ref) < 2e-4


def test_timestep_embedding():
    from gpt_image_edit_tpu.models.flux.model import timestep_embedding as jte

    t = np.array([0.0, 250.0, 999.0], np.float32)
    # arguments reach ~1000, where one fp32 ulp of the argument is 6e-5
    np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t), 256).numpy(),
                               np.asarray(jte(jnp.asarray(t), 256)), atol=1e-4)


def test_init_tree_matches_jax_layout():
    cfg = FluxConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    ours = init_flux(cfg, generator=gen, device="cpu")
    ref = jax.eval_shape(lambda: jinit(jax.random.key(0), JFluxConfig.tiny()))
    flat_ref = {jax.tree_util.keystr(k): tuple(v.shape)
                for k, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat_ours = {jax.tree_util.keystr(k): tuple(v.shape)
                 for k, v in jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert flat_ours == flat_ref
