"""Port parity: the T5 and CLIP text encoders and `FluxTextEncoders` in its
synthetic mode, against the JAX package on the same tiny weights and ids
(fp32, CPU). The fake tokenizer's ids run past both vocabularies; JAX's
gathers clamp them and so does the port, explicitly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.data.tokenizer import FakeTokenizer as JFakeTokenizer
from gpt_image_edit_tpu.models import clip as jclip
from gpt_image_edit_tpu.models import t5 as jt5
from gpt_image_edit_tpu.ops.attention import dot_product_attention as jattention
from gpt_image_edit_tpu.utils.prompt_embeds import FluxTextEncoders as JFluxTextEncoders
from gpt_image_edit_tpu_torch.data.tokenizer import FakeTokenizer
from gpt_image_edit_tpu_torch.models import clip, t5
from gpt_image_edit_tpu_torch.ops.attention import dot_product_attention as tattention
from gpt_image_edit_tpu_torch.utils.convert import from_jax
from gpt_image_edit_tpu_torch.utils.prompt_embeds import FluxTextEncoders

torch.set_num_threads(2)

# fp32 on both sides: summation order and the last bits of rsqrt/erf/tanh
TOL = dict(rtol=1e-4, atol=1e-5)
# CLIP-L's positions (77) with tiny widths, so 77-token prompts run
CLIP_CFG = dataclasses.replace(clip.ClipTextConfig.tiny(), max_position_embeddings=77)
JCLIP_CFG = dataclasses.replace(jclip.ClipTextConfig.tiny(), max_position_embeddings=77)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def t5_weights():
    jp = _np_tree(jt5.init(jax.random.key(0), jt5.T5Config.tiny()))
    return jp, from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def clip_weights():
    jp = _np_tree(jclip.init(jax.random.key(1), JCLIP_CFG))
    return jp, from_jax(jp, device="cpu")


def _ids(texts, length):
    return FakeTokenizer()(texts, padding="max_length", max_length=length,
                           truncation=True)["input_ids"]


@pytest.mark.parametrize("masked", [False, True])
def test_t5_matches_jax(t5_weights, masked):
    """Relative-position bias into K1's bias input at scale 1.0; out-of-range
    ids (up to 151,643 against a 512-row table) clamp as in JAX."""
    jp, tp = t5_weights
    ids = _ids(["a photo of a cat", "make the sky dramatic and dark"], 24)
    ids[0, 3] = 7  # one id inside the table
    assert ids.max() >= jt5.T5Config.tiny().vocab_size
    mask = (np.arange(24)[None] < np.array([[20], [24]])).astype(np.int64) if masked else None
    out = t5.apply(tp, t5.T5Config.tiny(), torch.from_numpy(ids),
                   None if mask is None else torch.from_numpy(mask)).numpy()
    ref = np.asarray(jt5.apply(jax.tree_util.tree_map(jnp.asarray, jp), jt5.T5Config.tiny(),
                               jnp.asarray(ids), None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(out, ref, **TOL)


def test_t5_relative_buckets_match_jax():
    cfg = t5.T5Config()
    np.testing.assert_array_equal(t5.relative_bias_table(cfg, 300),
                                  jt5.relative_bias_table(jt5.T5Config(), 300))


@pytest.mark.parametrize("case", ["clip_causal", "t5_pad_bias", "fully_masked_rows"])
def test_encoder_attention_on_k1_matches_jax_xla(case):
    """T5 and CLIP ask the JAX front end for its XLA path by name; the port
    runs them on K1 (here its plain version). Both compute the same function
    on every row that sees a key. A row that sees none gives 0 on K1 and the
    mean of v on XLA (its masked logits are the finite -0.7 FLT_MAX); no
    encoder row is such a row."""
    b, s, h, d = 2, 77, 4, 64
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    kw, live = {}, np.ones((b, s), bool)
    if case == "clip_causal":
        kw = {"causal": True}
    elif case == "t5_pad_bias":
        q, k = q * d ** -0.25, k * d ** -0.25  # unit-scale logits at scale 1.0, as in T5
        pm = (np.arange(s)[None] < np.array([[60], [77]])).astype(np.int32)
        kw = {"pad_mask": pm, "bias": rng.standard_normal((1, h, s, s)).astype(np.float32),
              "scale": 1.0}
    else:
        qs = np.zeros((b, s), np.int32)
        qs[:, 5:9] = 3  # no key carries segment 3
        kw = {"q_segment_ids": qs, "kv_segment_ids": np.zeros((b, s), np.int32)}
        live = qs == 0
    ref = np.asarray(jattention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla",
                                **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
                                   for n, x in kw.items()}))
    out = tattention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                     **{n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
                        for n, x in kw.items()}).numpy()
    # fp32 on both sides; the sums run in another order
    np.testing.assert_allclose(out[live], ref[live], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(out[~live], 0.0)


@pytest.mark.parametrize("with_eos", [False, True])
def test_clip_matches_jax(clip_weights, with_eos):
    """Causal, on K1; pooled at the first EOS, or at position 0
    when the ids carry none (the fake tokenizer's pad id clamps to the last
    row for the gather but is no EOS)."""
    jp, tp = clip_weights
    ids = _ids(["a photo of a cat", "make it dramatic"], 77)
    if with_eos:
        ids[0, 4] = ids[1, 9] = CLIP_CFG.eos_token_id
    hidden, pooled = clip.apply(tp, CLIP_CFG, torch.from_numpy(ids))
    jhidden, jpooled = jclip.apply(jax.tree_util.tree_map(jnp.asarray, jp), JCLIP_CFG,
                                   jnp.asarray(ids))
    np.testing.assert_allclose(hidden.numpy(), np.asarray(jhidden), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)


def test_flux_text_encoders_synthetic_match_jax(t5_weights, clip_weights):
    """`encode_prompt([text], 256)`, the runtime's call, with the same
    weights injected into both containers (the JAX synthetic weights are a
    constant fill; the port's are seeded random)."""
    jt5p, tt5p = t5_weights
    jclipp, tclipp = clip_weights
    jenc = JFluxTextEncoders("<synthetic>", synthetic=True)
    jenc.t5_cfg, jenc.clip_cfg = jt5.T5Config.tiny(), JCLIP_CFG
    jenc._t5 = (JFakeTokenizer(), jax.tree_util.tree_map(jnp.asarray, jt5p))
    jenc._clip = (JFakeTokenizer(), jax.tree_util.tree_map(jnp.asarray, jclipp))
    enc = FluxTextEncoders(device="cpu")
    enc.t5_cfg, enc.clip_cfg = t5.T5Config.tiny(), CLIP_CFG
    enc._t5, enc._clip = (FakeTokenizer(), tt5p), (FakeTokenizer(), tclipp)
    text = "make the sky dramatic"
    emb, pooled = enc.encode_prompt([text], 256)
    jemb, jpooled = jenc.encode_prompt([text], 256)
    assert emb.shape == (1, 256, jt5.T5Config.tiny().d_model)
    np.testing.assert_allclose(emb.numpy(), np.asarray(jemb), **TOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)


def test_flux_text_encoders_build_seeded_random_weights():
    """Synthetic weights are random, from the seed, not a constant fill."""
    encs = [FluxTextEncoders(device="cpu", seed=s) for s in (7, 7, 8)]
    for e in encs:
        e.t5_cfg, e.clip_cfg = t5.T5Config.tiny(), CLIP_CFG
    outs = [e.encode_prompt(["a cat"], 16) for e in encs]
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    assert not torch.equal(outs[0][0], outs[2][0])
    assert outs[0][1].std() > 0
