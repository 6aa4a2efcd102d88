"""Port parity: VAE encode/decode against the JAX model on the same tiny
weights and numpy images (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.models.common import cast_floating
from gpt_image_edit_tpu.models.vae import VaeConfig as JVaeConfig
from gpt_image_edit_tpu.models.vae import decode_from_scaled_latents as jdecode
from gpt_image_edit_tpu.models.vae import encode_to_scaled_latents as jencode
from gpt_image_edit_tpu.models.vae import init_vae as jinit
from gpt_image_edit_tpu_torch.models.vae import (
    VaeConfig,
    decode_from_scaled_latents,
    encode_to_scaled_latents,
    init_vae,
)
from gpt_image_edit_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def setup():
    params = jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(3), JVaeConfig.tiny()))
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 32, 24, 3)).astype(np.float32)
    z = rng.standard_normal((2, 8, 6, 4)).astype(np.float32)
    return params, img, z


# fp32: summation order only; bf16: the frameworks round at different places
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode(setup, dtype):
    params, img, _ = setup
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ref = jencode(cast_floating(jax.tree_util.tree_map(jnp.asarray, params), jdt), JVaeConfig.tiny(),
                  jnp.asarray(img).astype(jdt))
    out = encode_to_scaled_latents(from_jax(params, device="cpu", dtype=dtype), VaeConfig.tiny(),
                                   torch.from_numpy(img).to(dtype))
    assert out.shape == (2, 8, 6, 4) and out.dtype == dtype
    assert _rel_l2(out.float().numpy(), np.asarray(ref.astype(jnp.float32))) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode(setup, dtype):
    params, _, z = setup
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    ref = jdecode(cast_floating(jax.tree_util.tree_map(jnp.asarray, params), jdt), JVaeConfig.tiny(),
                  jnp.asarray(z).astype(jdt))
    out = decode_from_scaled_latents(from_jax(params, device="cpu", dtype=dtype), VaeConfig.tiny(),
                                     torch.from_numpy(z).to(dtype))
    assert out.shape == (2, 32, 24, 3) and out.dtype == dtype
    assert _rel_l2(out.float().numpy(), np.asarray(ref.astype(jnp.float32))) < TOL[dtype]


def test_init_tree_matches_jax_layout():
    ours = init_vae(VaeConfig.tiny(), generator=torch.Generator().manual_seed(0), device="cpu")
    ref = from_jax(jax.tree_util.tree_map(np.asarray, jinit(jax.random.key(0), JVaeConfig.tiny())),
                   device="cpu")
    shapes = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)  # noqa: E731
                        for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(ours) == shapes(ref)
