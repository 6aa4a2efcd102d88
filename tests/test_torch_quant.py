"""Port parity: weight quantization (`utils/quantize.py`) and the quantized
branches of `models/common.py` against the JAX package on the same numpy
weights and inputs (CPU)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.models import common as jc
from gpt_image_edit_tpu.models.flux import FluxConfig as JFluxConfig
from gpt_image_edit_tpu.models.flux import init_flux as jinit_flux
from gpt_image_edit_tpu.utils import quantize as jq
from gpt_image_edit_tpu_torch.models import common as tc
from gpt_image_edit_tpu_torch.utils import quantize as tq
from gpt_image_edit_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)

MODES = ("weight_only", "w8a8", "int4")
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the value's binade


def _np(x):
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_bf16_close(out, ref, ulps=2):
    """Outputs of the bf16 epilogue: within `ulps` bf16 ulps of the
    reference (the two frameworks may round an intermediate differently)."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    tol = ulps * BF16_ULP * np.maximum(np.abs(ref), 1e-30) + 1e-30
    assert (np.abs(out - ref) <= tol).all(), np.max(np.abs(out - ref) / tol)


# --------------------------------------------------------------------------
# utils/quantize.py
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(128, 96), (3, 128, 64)])
def test_quantize_kernel_matches_jax(mode, shape):
    k = _rand(shape, 0)
    k[..., 5] = 0.0  # an all-zero output channel takes scale 1
    ref = jax.tree_util.tree_map(np.asarray, jq.quantize_kernel(jnp.asarray(k), mode))
    out = tq.quantize_kernel(torch.from_numpy(k), mode)
    assert sorted(out) == sorted(ref)
    for name in ref:
        # the same fp32 division and half-to-even rounding: codes and
        # scales are equal, not close
        assert out[name].dtype == {"int8": torch.int8, "uint8": torch.uint8,
                                   "float32": torch.float32}[ref[name].dtype.name]
        np.testing.assert_array_equal(out[name].numpy(), ref[name])
    back = tq.dequantize_kernel(out, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jq.dequantize_kernel(_jtree(ref), jnp.float32)))


def test_quantize_kernel_bf16_input():
    k = _rand((64, 32), 1).astype(ml_dtypes.bfloat16)
    ref = jq.quantize_kernel(jnp.asarray(k), "w8a8")
    out = tq.quantize_kernel(torch.from_numpy(k.astype(np.float32)).bfloat16(), "w8a8")
    np.testing.assert_array_equal(out["q_w8a8"].numpy(), np.asarray(ref["q_w8a8"]))
    np.testing.assert_array_equal(out["scale"].numpy(), np.asarray(ref["scale"]))


@pytest.mark.parametrize("mode", MODES)
def test_quantize_params_matches_jax(mode):
    params = jax.tree_util.tree_map(np.asarray, jinit_flux(jax.random.key(0), JFluxConfig.tiny()))
    ref = jax.tree_util.tree_map(np.asarray,
                                 jq.quantize_params(_jtree(params), min_size=1024, mode=mode))
    tree = from_jax(params, device="cpu")
    out = tq.quantize_params(tree, min_size=1024, mode=mode)
    assert out is tree  # in place
    flat_ref, flat_out = dict(_flat(ref)), dict(_flat(out))
    assert flat_out.keys() == flat_ref.keys()
    n_quantized = 0
    for path, r in flat_ref.items():
        o = flat_out[path].numpy()
        assert o.dtype == r.dtype, path
        np.testing.assert_array_equal(o, r, err_msg=path)
        n_quantized += path.endswith(("/q", "/q_w8a8", "/q4"))
    assert n_quantized > 10
    assert tq.params_nbytes(out) == jq.params_nbytes(_jtree(ref))


def test_quantize_params_mode_for_and_filter():
    params = {"a": {"kernel": _rand((64, 64), 2)}, "b": {"kernel": _rand((64, 64), 3)},
              "c": [{"kernel": _rand((64, 64), 4)}], "small": {"kernel": _rand((4, 4), 5)}}
    mode_for = {"a/kernel": "w8a8", "b/kernel": None, "c/0/kernel": "int4"}.get
    ref = jq.quantize_params(_jtree(params), min_size=1024, mode_for=mode_for)
    out = tq.quantize_params(from_jax(params, device="cpu"), min_size=1024, mode_for=mode_for)
    assert sorted(out["a"]["kernel"]) == ["q_w8a8", "scale"]
    assert torch.is_tensor(out["b"]["kernel"]) and torch.is_tensor(out["small"]["kernel"])
    assert sorted(out["c"][0]["kernel"]) == ["q4", "scale4"]
    for (path, r), (_, o) in zip(_flat(jax.tree_util.tree_map(np.asarray, ref)), _flat(out)):
        np.testing.assert_array_equal(o.numpy(), r, err_msg=path)
    only_a = tq.quantize_params(from_jax(params, device="cpu"), min_size=1024,
                                path_filter=lambda p: p.startswith("a/"))
    assert isinstance(only_a["a"]["kernel"], dict) and torch.is_tensor(only_a["b"]["kernel"])


def test_from_jax_keeps_quantized_leaves():
    q = jax.tree_util.tree_map(np.asarray, jq.quantize_kernel(jnp.asarray(_rand((2, 64, 32), 6)),
                                                              "w8a8"))
    tree = {"kernel": q, "bias": np.zeros(32, np.float32)}
    out = from_jax(tree, device="cpu", dtype=torch.bfloat16)
    assert out["bias"].dtype == torch.bfloat16
    assert out["kernel"]["q_w8a8"].dtype == torch.int8 and out["kernel"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(out["kernel"]["q_w8a8"].numpy(), q["q_w8a8"])
    np.testing.assert_array_equal(out["kernel"]["scale"].numpy(), q["scale"])
    assert tuple(out["kernel"]["scale"].shape) == (2, 1, 32)
    # the W8A8 codes keep their shape and values, stored input-axis first
    assert out["kernel"]["q_w8a8"].stride()[-2] == 1


def test_w8a8_codes_layout():
    q = tq.quantize_kernel(torch.randn(3, 64, 48), "w8a8")["q_w8a8"]
    assert tuple(q.shape) == (3, 64, 48) and q[1].stride() == (1, 64)
    x = torch.randint(-127, 128, (5, 64), dtype=torch.int8)
    torch.testing.assert_close(torch._int_mm(x, q[1]), torch._int_mm(x, q[1].contiguous()),
                               rtol=0, atol=0)


def test_first_leaf_of_a_quantized_tree():
    tree = {"x": {"kernel": tq.quantize_kernel(torch.ones(4, 4), "w8a8")}}
    assert tc.first_leaf(tree).dtype == torch.int8


# --------------------------------------------------------------------------
# models/common.py, quantized branches
# --------------------------------------------------------------------------

def _w8a8(shape, seed):
    """A W8A8 kernel dict for both packages, from one fp32 kernel."""
    q = jax.tree_util.tree_map(np.asarray, jq.quantize_kernel(jnp.asarray(_rand(shape, seed, 0.1)),
                                                              "w8a8"))
    return _jtree(q), {k: torch.from_numpy(np.array(v)) for k, v in q.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows(dtype):
    x = _rand((2, 33, 96), 7, 3.0).astype(ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    x[1, 4] = 0  # an all-zero row takes the 1e-8 floor
    qj, sj = jc.quantize_rows(jnp.asarray(x))
    qt, st = tc.quantize_rows(torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype)))
    # identical math on identical inputs: codes equal, scales equal
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert qt.dtype == torch.int8 and tuple(st.shape) == (2, 33, 1)


def test_quantize_gelu_rows():
    pre = _rand((3, 17, 128), 8, 2.0)
    pre[0, 0] = -np.abs(pre[0, 0])  # a row below the gelu dip: the 0.1701 bound
    qj, sj = jc.quantize_gelu_rows(jnp.asarray(pre))
    qt, st = tc.quantize_gelu_rows(torch.from_numpy(pre))
    assert tc._GELU_TANH_MIN == jc._GELU_TANH_MIN
    # XLA's and torch's tanh differ in the last fp32 bit: a code on a
    # rounding tie may move by 1 LSB, the scales by an fp32 ulp
    assert np.abs(qt.numpy().astype(int) - np.asarray(qj).astype(int)).max() <= 1
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    assert float(st[0, 0, 0]) == pytest.approx(0.1701 / 127, rel=1e-6)


@pytest.mark.parametrize("epilogue", ["bf16", "f32"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_linear_w8a8(monkeypatch, epilogue, dtype):
    monkeypatch.setenv("GIE_W8A8_EPILOGUE", epilogue)
    kj, kt = _w8a8((96, 64), 9)
    bias = _rand((64,), 10, 0.1)
    x = jnp.asarray(_rand((2, 20, 96), 11), dtype)
    ref = _np(jc.linear({"kernel": kj, "bias": jnp.asarray(bias)}, x))
    tx = torch.from_numpy(_np(x)).to(torch.float32 if dtype == jnp.float32 else torch.bfloat16)
    out = tc.linear({"kernel": kt, "bias": torch.from_numpy(bias)}, tx)
    assert out.dtype == tx.dtype
    # exact int32 products; the epilogue rounds in bf16 (or fp32) in the
    # same order in both, up to XLA's excess precision between bf16 ops
    _assert_bf16_close(out.float().numpy(), ref)


def test_linear_w8a8_one_row_and_quant_rows_input():
    kj, kt = _w8a8((64, 48), 12)
    x = _rand((1, 64), 13)
    ref = _np(jc.linear({"kernel": kj}, jnp.asarray(x)))
    _assert_bf16_close(tc.linear({"kernel": kt}, torch.from_numpy(x)).numpy(), ref)
    qx, s_x = tc.quantize_rows(torch.from_numpy(x))
    rows = tc.QuantRows(qx, s_x, torch.float32)
    _assert_bf16_close(tc.linear({"kernel": kt}, rows).numpy(), ref)
    with pytest.raises(TypeError):
        tc.linear({"kernel": torch.zeros(64, 48)}, rows)


@pytest.mark.parametrize("mode", ["weight_only", "int4"])
def test_linear_weight_only(mode):
    k = _rand((128, 64), 14, 0.1)
    qj = jq.quantize_kernel(jnp.asarray(k), mode)
    qt = tq.quantize_kernel(torch.from_numpy(k), mode)
    x = _rand((5, 128), 15)
    ref = np.asarray(jc.linear({"kernel": qj}, jnp.asarray(x)))
    out = tc.linear({"kernel": qt}, torch.from_numpy(x)).numpy()
    # dequantized to fp32 exactly, then one fp32 product
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_linear_multi_shares_one_quantization():
    heads = [_w8a8((64, 32), 16 + i) for i in range(3)]
    bias = _rand((32,), 19, 0.1)
    x = _rand((2, 24, 64), 20)
    refs = jc.linear_multi([{"kernel": kj, "bias": jnp.asarray(bias)} for kj, _ in heads],
                           jnp.asarray(x))
    outs = tc.linear_multi([{"kernel": kt, "bias": torch.from_numpy(bias)} for _, kt in heads],
                           torch.from_numpy(x))
    for out, ref in zip(outs, refs):
        _assert_bf16_close(out.numpy(), _np(ref))
    # the same codes as per-head linear
    for (_, kt), out in zip(heads, outs):
        torch.testing.assert_close(out, tc.linear({"kernel": kt, "bias": torch.from_numpy(bias)},
                                                  torch.from_numpy(x)), rtol=0, atol=0)


def test_linear_gelu_w8a8():
    kj, kt = _w8a8((128, 48), 21)
    pre = _rand((2, 9, 128), 22, 2.0)
    ref = _np(jc.linear_gelu({"kernel": kj}, jnp.asarray(pre)))
    out = tc.linear_gelu({"kernel": kt}, torch.from_numpy(pre)).numpy()
    # gelu's last-bit difference may move a code by 1 LSB (1/127 of the row
    # scale); the products then differ by at most that code's share
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 2e-3, rel


def test_linear_concat_w8a8_split_per_part():
    kj, kt = _w8a8((64 + 128, 32), 23)
    bias = _rand((32,), 24, 0.1)
    attn = _rand((2, 10, 64), 25)
    pre = _rand((2, 10, 128), 26, 2.0)
    ref = _np(jc.linear_concat({"kernel": kj, "bias": jnp.asarray(bias)},
                               [jnp.asarray(attn), ("gelu", jnp.asarray(pre))]))
    out = tc.linear_concat({"kernel": kt, "bias": torch.from_numpy(bias)},
                           [torch.from_numpy(attn), ("gelu", torch.from_numpy(pre))]).numpy()
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 2e-3, rel
    with pytest.raises(ValueError):
        tc.linear_concat({"kernel": kt}, [torch.from_numpy(attn)])


@pytest.mark.parametrize("epilogue", ["bf16", "f32"])
@pytest.mark.parametrize("mode", ["w8a8", "weight_only", "int4"])
def test_adaln_stacked_quantized(monkeypatch, mode, epilogue):
    monkeypatch.setenv("GIE_W8A8_EPILOGUE", epilogue)
    k = _rand((3, 64, 6 * 32), 27, 0.1)
    bias = _rand((3, 6 * 32), 28, 0.1)
    qj = jq.quantize_kernel(jnp.asarray(k), mode)
    qt = tq.quantize_kernel(torch.from_numpy(k), mode)
    silu = _rand((2, 64), 29)
    ref = _np(jc.adaln_stacked({"kernel": qj, "bias": jnp.asarray(bias)}, jnp.asarray(silu), 6))
    out = tc.adaln_stacked({"kernel": qt, "bias": torch.from_numpy(bias)},
                           torch.from_numpy(silu), 6).numpy()
    assert out.shape == ref.shape == (3, 6, 2, 32)
    if mode == "w8a8":
        _assert_bf16_close(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
