"""Port parity: norms, rope, packing and the attention plain version against
the JAX package on the same numpy inputs (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.ops import norms as jnorms
from gpt_image_edit_tpu.ops import packing as jpacking
from gpt_image_edit_tpu.ops import rope as jrope
from gpt_image_edit_tpu.ops.attention import dot_product_attention as jax_attention
from gpt_image_edit_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from gpt_image_edit_tpu_torch.models import common as tcommon
from gpt_image_edit_tpu_torch.ops import norms as tnorms
from gpt_image_edit_tpu_torch.ops import packing as tpacking
from gpt_image_edit_tpu_torch.ops import rope as trope
from gpt_image_edit_tpu_torch.ops.attention import dot_product_attention
from gpt_image_edit_tpu_torch.ops.kernels.flash_attention import flash_attention

torch.set_num_threads(2)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


class TestNorms:
    # XLA's CPU rsqrt and reduction order differ from torch's in the last
    # bit, so the norms are held to 4 fp32 ulps (rtol 5e-7), not bit-exact.
    RTOL = 5e-7

    def test_rms_norm(self):
        x, w = _rand((2, 37, 96), 0), _rand((96,), 1)
        ref = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w)))
        out = tnorms.rms_norm(_t(x), _t(w)).numpy()
        np.testing.assert_allclose(out, ref, rtol=self.RTOL, atol=1e-7)

    def test_layer_norm_affine(self):
        x, w, b = _rand((2, 37, 96), 0), _rand((96,), 1), _rand((96,), 2)
        ref = np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
        out = tnorms.layer_norm(_t(x), _t(w), _t(b)).numpy()
        np.testing.assert_allclose(out, ref, rtol=self.RTOL, atol=1e-6)

    def test_modulate_bit_exact(self):
        x, sh, sc = _rand((2, 9, 32), 0), _rand((2, 32), 1), _rand((2, 32), 2)
        ref = np.asarray(jnorms.modulate(jnp.asarray(x), jnp.asarray(sh), jnp.asarray(sc)))
        np.testing.assert_array_equal(tnorms.modulate(_t(x), _t(sh), _t(sc)).numpy(), ref)

    def test_group_norm(self):
        from gpt_image_edit_tpu.models.common import group_norm as jgn

        x = _rand((2, 6, 5, 32), 3)
        p = {"scale": _rand((32,), 4), "bias": _rand((32,), 5)}
        ref = np.asarray(jgn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), num_groups=8))
        out = tcommon.group_norm({k: _t(v) for k, v in p.items()}, _t(x), num_groups=8).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


class TestRope:
    def _ids(self):
        img = np.asarray(jpacking.latent_image_ids(6, 8, modality=1))
        return np.concatenate([np.zeros((5, 3), np.float32), img])

    def test_freq_tables(self):
        # cos/sin come from different libm implementations: within 1 ulp
        ids = self._ids()
        jc, js = jrope.flux_rope_freqs(jnp.asarray(ids), (16, 56, 56))
        tc, ts = trope.flux_rope_freqs(_t(ids), (16, 56, 56))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1.2e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1.2e-7)

    @pytest.mark.parametrize("rope_dtype", ["float32", "bfloat16"])
    def test_apply_rope_paired_bit_exact(self, rope_dtype):
        ids = self._ids()
        jc, js = jrope.flux_rope_freqs(jnp.asarray(ids), (16, 56, 56))
        jdt = jnp.bfloat16 if rope_dtype == "bfloat16" else jnp.float32
        tdt = torch.bfloat16 if rope_dtype == "bfloat16" else torch.float32
        jc, js = jc.astype(jdt), js.astype(jdt)
        tc = _t(np.asarray(jc.astype(jnp.float32))).to(tdt)
        ts = _t(np.asarray(js.astype(jnp.float32))).to(tdt)
        x = _rand((1, ids.shape[0], 3, 128), 0)
        ref = np.asarray(jrope.apply_rope_paired(jnp.asarray(x), jc[:, None], js[:, None]))
        out = trope.apply_rope_paired(_t(x), tc[:, None], ts[:, None]).numpy()
        np.testing.assert_array_equal(out, ref)


class TestPacking:
    def test_pack_unpack_bit_exact(self):
        x = _rand((2, 8, 12, 16), 0)
        ref = np.asarray(jpacking.pack_latents(jnp.asarray(x)))
        packed = tpacking.pack_latents(_t(x))
        np.testing.assert_array_equal(packed.numpy(), ref)
        np.testing.assert_array_equal(tpacking.unpack_latents(packed, 8, 12).numpy(), x)

    def test_latent_image_ids(self):
        ref = np.asarray(jpacking.latent_image_ids(5, 7, modality=2))
        np.testing.assert_array_equal(tpacking.latent_image_ids(5, 7, modality=2).numpy(), ref)


def _jax_flash(q, k, v, **kw):
    kw = {n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    return np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                                block_q=128, block_kv=128, **kw))


def _port(q, k, v, **kw):
    kw = {n: (_t(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    return dot_product_attention(_t(q), _t(k), _t(v), **kw).numpy()


class TestAttentionPlain:
    """The kernel's plain version (what a CPU tensor runs) against the
    Pallas kernel in interpret mode, fp32; atol 2e-5 covers the two
    softmax orders (online base-2 vs one-pass natural exp)."""
    ATOL = 2e-5

    def test_pad_mask(self):
        b, s, h, d = 2, 256, 2, 64
        q, k, v = (_rand((b, s, h, d), i) for i in range(3))
        pad = np.ones((b, s), bool)
        pad[0, -32:] = False
        pad[1, 100:228] = False
        np.testing.assert_allclose(_port(q, k, v, pad_mask=pad), _jax_flash(q, k, v, pad_mask=pad),
                                   atol=self.ATOL)

    def test_segments(self):
        b, s, h, d = 2, 256, 2, 64
        q, k, v = (_rand((b, s, h, d), i) for i in range(3, 6))
        seg = np.repeat(np.arange(4), 64)[None].repeat(b, 0).astype(np.int32)
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg)
        np.testing.assert_allclose(_port(q, k, v, **kw), _jax_flash(q, k, v, **kw), atol=self.ATOL)

    def test_gqa(self):
        q = _rand((1, 256, 4, 64), 6)
        k, v = _rand((1, 256, 2, 64), 7), _rand((1, 256, 2, 64), 8)
        np.testing.assert_allclose(_port(q, k, v), _jax_flash(q, k, v), atol=self.ATOL)

    def test_causal_square(self):
        q, k, v = (_rand((1, 256, 2, 64), i) for i in range(9, 12))
        np.testing.assert_allclose(_port(q, k, v, causal=True), _jax_flash(q, k, v, causal=True),
                                   atol=self.ATOL)

    @pytest.mark.parametrize("sq,skv", [(128, 256), (200, 100)])
    def test_causal_sq_ne_skv_end_aligned(self, sq, skv):
        """End-aligned causal as in `_build_mask` (the JAX XLA path). The
        Pallas kernel aligns the diagonal to the start when sq != skv, so
        the XLA path is the reference here. Rows of the sq > skv case that
        see no key are 0 in the port and the mean of v under XLA's uniform
        softmax over _NEG_INF, so only rows with >= 1 key are compared."""
        q = _rand((1, sq, 2, 64), 12)
        k, v = _rand((1, skv, 2, 64), 13), _rand((1, skv, 2, 64), 14)
        ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       causal=True, impl="xla"))
        out = _port(q, k, v, causal=True)
        live = np.arange(sq) + (skv - sq) >= 0
        np.testing.assert_allclose(out[:, live], ref[:, live], atol=self.ATOL)
        np.testing.assert_array_equal(out[:, ~live], 0.0)

    def test_fully_masked_row_is_zero(self):
        b, s, h, d = 1, 128, 2, 64
        q, k, v = (_rand((b, s, h, d), i) for i in range(15, 18))
        qs = np.zeros((b, s), np.int32)
        qs[0, 5] = 7  # a segment no key has
        kw = dict(q_segment_ids=qs, kv_segment_ids=np.zeros((b, s), np.int32))
        ref = _jax_flash(q, k, v, **kw)
        out = _port(q, k, v, **kw)
        np.testing.assert_allclose(out, ref, atol=self.ATOL)
        np.testing.assert_array_equal(out[0, 5], 0.0)

    def test_bias_and_scale(self):
        q, k, v = (_rand((2, 64, 2, 64), i) for i in range(18, 21))
        bias = _rand((1, 2, 64, 64), 21)
        kw = dict(bias=bias, scale=0.05)
        ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), impl="xla",
                                       bias=jnp.asarray(bias), scale=0.05))
        np.testing.assert_allclose(_port(q, k, v, **kw), ref, atol=self.ATOL)

    def test_rejects_one_sided_segments(self):
        q = torch.zeros(1, 8, 1, 64)
        with pytest.raises(ValueError):
            flash_attention(q, q, q, q_segment_ids=torch.zeros(1, 8, dtype=torch.int32))


class TestCommon:
    def test_linear_and_adaln_stacked(self):
        from gpt_image_edit_tpu.models import common as jcommon

        x, w, b = _rand((2, 5, 16), 0), _rand((16, 24), 1), _rand((24,), 2)
        ref = np.asarray(jcommon.linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}, jnp.asarray(x)))
        out = tcommon.linear({"kernel": _t(w), "bias": _t(b)}, _t(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
        ws, bs, t = _rand((3, 16, 24), 3), _rand((3, 24), 4), _rand((2, 16), 5)
        ref = np.asarray(jcommon.adaln_stacked({"kernel": jnp.asarray(ws), "bias": jnp.asarray(bs)},
                                               jnp.asarray(t), 6))
        out = tcommon.adaln_stacked({"kernel": _t(ws), "bias": _t(bs)}, _t(t), 6).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)

    def test_cast_floating_keeps_ints(self):
        tree = {"a": [torch.zeros(2), torch.zeros(2, dtype=torch.int32)], "b": {"c": torch.ones(3)}}
        out = tcommon.cast_floating(tree, torch.bfloat16, "cpu")
        assert out["a"][0].dtype == torch.bfloat16 and out["b"]["c"].dtype == torch.bfloat16
        assert out["a"][1].dtype == torch.int32

    def test_quantized_kernel_raises(self):
        """Quantized kernels are ported (tests/test_torch_quant.py holds them
        to JAX); what raises is a mismatch: int8 rows into a plain kernel, or
        an activation wider than the int8 codes."""
        p = {"kernel": {"q_w8a8": torch.ones(8, 8, dtype=torch.int8), "scale": torch.ones(1, 8)}}
        assert tcommon.linear(p, torch.ones(2, 8)).shape == (2, 8)
        with pytest.raises(RuntimeError):
            tcommon.linear(p, torch.zeros(2, 16))
        rows = tcommon.QuantRows(*tcommon.quantize_rows(torch.ones(2, 8)), torch.float32)
        with pytest.raises(TypeError):
            tcommon.linear({"kernel": torch.zeros(8, 8)}, rows)

    def test_conv2d_matches_jax(self):
        from gpt_image_edit_tpu.models import common as jcommon
        from gpt_image_edit_tpu_torch.utils.convert import from_jax

        x = _rand((2, 9, 7, 8), 0)
        for k, stride, pad in [(3, 1, "SAME"), (1, 1, "SAME"), (3, 2, [(0, 1), (0, 1)])]:
            p = {"kernel": _rand((k, k, 8, 12), k), "bias": _rand((12,), 9)}
            ref = np.asarray(jcommon.conv2d(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                            stride=stride, padding=pad))
            out = tcommon.conv2d(from_jax(p, device="cpu"), _t(x), stride=stride, padding=pad).numpy()
            np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
