"""Port parity: K2, the fused ln + modulate + int8 row quantization, and the
W8A8 FLUX forward that runs it, against the JAX package (CPU). The Pallas
kernel runs in interpret mode, as tests/test_fused_quant.py runs it; the
port's wrapper takes the kernel's plain version on a CPU tensor."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.models.common import quantize_rows as jquantize_rows
from gpt_image_edit_tpu.models.flux import FluxConfig as JFluxConfig
from gpt_image_edit_tpu.models.flux import apply_flux as japply
from gpt_image_edit_tpu.models.flux import init_flux as jinit
from gpt_image_edit_tpu.ops.norms import layer_norm as jlayer_norm
from gpt_image_edit_tpu.ops.norms import modulate as jmodulate
from gpt_image_edit_tpu.ops.packing import latent_image_ids as jids
from gpt_image_edit_tpu.ops.pallas.fused_quant import ln_modulate_quant_rows as jfused
from gpt_image_edit_tpu.utils.quantize import quantize_params as jquantize_params
from gpt_image_edit_tpu_torch.models import common as tc
from gpt_image_edit_tpu_torch.models.flux import FluxConfig, apply_flux
from gpt_image_edit_tpu_torch.ops.kernels import fused_quant as fq
from gpt_image_edit_tpu_torch.utils.convert import from_jax
from gpt_image_edit_tpu_torch.utils.quantize import quantize_kernel

torch.set_num_threads(2)


def _bf16(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


def _t(a):
    return torch.from_numpy(a.astype(np.float32)).bfloat16()


@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 384, 256)])
def test_plain_version_matches_pallas_interpret(shape):
    b, s, d = shape
    x = _bf16(shape, 0, 3.0)
    shift, scale = _bf16((b, d), 1, 0.1), _bf16((b, d), 2, 0.1)  # B = 2: per-batch rows
    qj, sj = jfused(jnp.asarray(x), jnp.asarray(shift), jnp.asarray(scale),
                    block_rows=128, interpret=True)
    qt, st = fq.ln_modulate_quant_rows(_t(x), _t(shift), _t(scale))
    assert qt.dtype == torch.int8 and tuple(st.shape) == (b, s, 1)
    # the JAX package's bar (tests/test_fused_quant.py): codes
    # within 1 LSB, scales within one bf16 ulp of the row max. Compiled on
    # the CPU, XLA keeps the modulated value in fp32 where the kernel
    # rounds it to bf16 (its excess-precision rewrite drops the bf16 -> fp32
    # round trip), so several percent of the codes sit 1 LSB apart here
    diff = np.abs(qt.numpy().astype(int) - np.asarray(qj).astype(int))
    assert diff.max() <= 1
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2.0 ** -7)
    # op by op (no jit) the JAX chain rounds every bf16 op, as the kernel
    # and its plain version do: equal codes, equal scales
    qe, se = jquantize_rows(jmodulate(jlayer_norm(jnp.asarray(x), eps=1e-6),
                                      jnp.asarray(shift), jnp.asarray(scale)))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qe))
    np.testing.assert_array_equal(st.numpy(), np.asarray(se))


def test_batch_rows_take_their_own_shift_and_scale():
    x = _t(_bf16((1, 64, 128), 3))
    shift, scale = _t(_bf16((2, 128), 4, 0.3)), _t(_bf16((2, 128), 5, 0.3))
    both = fq.ln_modulate_quant_rows(torch.cat([x, x]), shift, scale)
    for i in range(2):
        one = fq.ln_modulate_quant_rows(x, shift[i:i + 1], scale[i:i + 1])
        torch.testing.assert_close(both[0][i], one[0][0], rtol=0, atol=0)
        torch.testing.assert_close(both[1][i], one[1][0], rtol=0, atol=0)


def test_any_sequence_length():
    """No row blocks: an S the Pallas kernel refuses runs here."""
    x = _t(_bf16((1, 100, 128), 6))
    sh, sc = _t(_bf16((1, 128), 7, 0.1)), _t(_bf16((1, 128), 8, 0.1))
    q, s = fq.ln_modulate_quant_rows(x, sh, sc)
    with pytest.raises(ValueError):
        jfused(jnp.asarray(x.float().numpy()), jnp.asarray(sh.float().numpy()),
               jnp.asarray(sc.float().numpy()), block_rows=64, interpret=True)
    assert q.shape == (1, 100, 128) and s.shape == (1, 100, 1)


def test_dispatcher(monkeypatch):
    """ln_modulate_quant: QuantRows from K2 for a W8A8 consumer unless off,
    the modulated tensor otherwise."""
    probe = {"kernel": quantize_kernel(torch.randn(128, 64), "w8a8")}
    x = _t(_bf16((1, 32, 128), 9))
    sh, sc = _t(_bf16((1, 128), 10, 0.1)), _t(_bf16((1, 128), 11, 0.1))
    for mode in ("on", "interpret"):
        assert isinstance(tc.ln_modulate_quant(x, sh, sc, probe, mode=mode), tc.QuantRows)
    off = tc.ln_modulate_quant(x, sh, sc, probe, mode="off")
    assert torch.is_tensor(off) and off.dtype == torch.bfloat16
    plain = tc.ln_modulate_quant(x, sh, sc, {"kernel": torch.randn(128, 64)}, mode="on")
    torch.testing.assert_close(plain, off, rtol=0, atol=0)
    monkeypatch.setenv("GIE_FUSE_MOD_QUANT", "0")
    assert torch.is_tensor(tc.ln_modulate_quant(x, sh, sc, probe))
    monkeypatch.delenv("GIE_FUSE_MOD_QUANT")
    assert isinstance(tc.ln_modulate_quant(x, sh, sc, probe), tc.QuantRows)  # default on
    with pytest.raises(ValueError):
        tc.ln_modulate_quant(x, sh, sc, probe, mode="fast")


def test_cuda_tensor_goes_to_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(fq, "_ln_modulate_quant_rows_cuda",
                        lambda x, sh, sc, eps: calls.append(x) or "kernel")
    monkeypatch.setattr(fq, "ln_modulate_quant_rows_reference",
                        lambda *a, **k: pytest.fail("a CUDA tensor reached the plain version"))
    x = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert fq.ln_modulate_quant_rows(x, None, None) == "kernel" and calls == [x]


def test_kernel_wrapper_refuses_what_it_does_not_take():
    x = torch.zeros(1, 8, 128, dtype=torch.bfloat16, device="meta")
    sh = torch.zeros(1, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fq._ln_modulate_quant_rows_cuda(x, sh, sh, eps=1e-6)
    with pytest.raises(ValueError, match=r"\(B, D\)"):
        fq.ln_modulate_quant_rows(torch.zeros(2, 8, 16), torch.zeros(1, 16), torch.zeros(2, 16))


# --------------------------------------------------------------------------
# a tiny W8A8 FLUX forward with the fused prologue, against JAX
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def w8a8_flux():
    """Tiny FLUX (hidden 128) quantized W8A8 by the JAX package, and a
    request with S_img 256 and S_txt 128 so that every JAX prologue site is
    aligned and takes the Pallas kernel (tests/test_fused_quant.py)."""
    cfg = JFluxConfig.tiny()
    params = jquantize_params(jinit(jax.random.key(0), cfg), min_size=1024, mode="w8a8")
    rng = np.random.default_rng(1)
    inputs = dict(
        hidden_states=rng.standard_normal((1, 256, cfg.in_channels)).astype(np.float32),
        encoder_hidden_states=rng.standard_normal((1, 128, cfg.joint_attention_dim)).astype(np.float32),
        pooled_projections=rng.standard_normal((1, cfg.pooled_projection_dim)).astype(np.float32),
        timestep=np.array([0.4], np.float32),
        img_ids=np.array(jids(16, 16)),
        guidance=np.array([3.5], np.float32),
    )
    pad = np.ones((1, 384), bool)
    pad[0, 100:128] = False  # 28 of 128 text keys padded
    return cfg, jax.tree_util.tree_map(np.asarray, params), inputs, pad


@pytest.mark.parametrize("epilogue", ["bf16", "f32"])
@pytest.mark.parametrize("impl", ["auto", "pallas_qk8", "pallas_int8"])
def test_w8a8_flux_forward_matches_jax(monkeypatch, w8a8_flux, impl, epilogue):
    monkeypatch.setenv("GIE_W8A8_EPILOGUE", epilogue)
    cfg, params, inputs, pad = w8a8_flux
    jcfg = dataclasses.replace(cfg, attention_impl=impl, fuse_mod_quant="interpret")
    ref = np.asarray(japply(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                            pad_mask=jnp.asarray(pad), **{k: jnp.asarray(v) for k, v in inputs.items()}))
    tcfg = dataclasses.replace(FluxConfig.tiny(), attention_impl=impl, fuse_mod_quant="on")
    sites = []
    real = tc.ln_modulate_quant_rows

    def counting(x, *a, **k):
        sites.append(tuple(x.shape))
        return real(x, *a, **k)

    monkeypatch.setattr(tc, "ln_modulate_quant_rows", counting)
    out = apply_flux(from_jax(params, device="cpu"), tcfg, pad_mask=torch.from_numpy(pad),
                     **{k: torch.from_numpy(v) for k, v in inputs.items()}).numpy()
    assert len(sites) == 4 * tcfg.num_layers + tcfg.num_single_layers
    assert out.shape == ref.shape and np.isfinite(out).all()
    # bf16 epilogue: the JAX package's own fused-vs-plain bar. Jitted on the
    # CPU, XLA skips the epilogue's bf16 roundings (excess precision) that
    # the port performs, on every product's output. With the fp32 epilogue
    # that difference is gone and what is left is int8 codes on a rounding
    # tie moving by 1 LSB where a norm, a rope table or gelu differs in its
    # last fp32 bit: a tighter bar
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    assert rel < {"bf16": 5e-3, "f32": 1e-3}[epilogue], rel


def test_w8a8_flux_fused_matches_unfused(w8a8_flux):
    """Within the port: K2's plain version against the unfused chain
    quantized in the consuming linear (the same codes up to reduction
    order)."""
    cfg, params, inputs, pad = w8a8_flux
    tp = from_jax(params, device="cpu")
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    outs = [apply_flux(tp, dataclasses.replace(FluxConfig.tiny(), fuse_mod_quant=m),
                       pad_mask=torch.from_numpy(pad), **tin) for m in ("on", "off")]
    rel = float((outs[0] - outs[1]).norm() / outs[1].norm())
    assert rel < 5e-3, rel


def test_flux_config_values_checked(w8a8_flux):
    _, params, inputs, _ = w8a8_flux
    tp = from_jax(params, device="cpu")
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with pytest.raises(NotImplementedError):
        apply_flux(tp, dataclasses.replace(FluxConfig.tiny(), attention_impl="ring"), **tin)
    with pytest.raises(ValueError):
        apply_flux(tp, dataclasses.replace(FluxConfig.tiny(), fuse_mod_quant="yes"), **tin)
