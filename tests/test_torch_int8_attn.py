"""Port parity: K4, flash attention with int8 q k^T and int8 p v, against
the Pallas kernel `flash_attention_int8` in interpret mode (CPU), the
length contract on ragged shapes, and the attention front end's
"pallas_int8" route."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.ops.pallas.flash_attention import flash_attention_int8 as jk4
from gpt_image_edit_tpu.ops.pallas.flash_attention import flash_attention_qk8 as jk3
from gpt_image_edit_tpu_torch.ops import attention as tattn
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention_int8 as k4

torch.set_num_threads(2)

# The plain version repeats the Pallas kernel's arithmetic on the same int8
# codes (exact int32 products); only exp2 and the fp32 sums differ in their
# last bits, which moves a p8 code that sits near a rounding edge by 1:
# ~1e-7 relative L2 without such a code, up to 5.1e-5 with one (measured).
REL_L2 = 2e-4
MIN_RATIO = 10.0  # JAX K3 (bf16 p v, ~2e-2 away) at least this many times farther


def _qkv(b, sq, skv, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _masks(kind, b, s):
    """(jax kwargs, torch kwargs) for one mask case."""
    if kind == "full":
        return {}, {}
    if kind == "pad":
        pm = np.ones((b, s), bool)
        pm[:, 37:150] = False
        return {"pad_mask": jnp.asarray(pm)}, {"pad_mask": torch.from_numpy(pm)}
    if kind == "causal":
        return {"causal": True}, {"causal": True}
    if kind == "segments":
        seg = (np.arange(s) // 100)[None].repeat(b, 0).astype(np.int32)
        return ({"q_segment_ids": jnp.asarray(seg), "kv_segment_ids": jnp.asarray(seg)},
                {"q_segment_ids": torch.from_numpy(seg), "kv_segment_ids": torch.from_numpy(seg)})
    raise ValueError(kind)


@pytest.mark.parametrize("block_kv", [128, 512])
@pytest.mark.parametrize("case", [
    # (B, S, Hq, Hkv, D, mask): S = 512 is one group at 512 and four at 128
    (1, 512, 2, 2, 128, "full"),
    (1, 512, 2, 2, 64, "pad"),
    (2, 512, 4, 2, 64, "causal"),     # GQA 4/2, causal
    (1, 512, 2, 2, 64, "segments"),
], ids=["full", "pad", "gqa_causal", "segments"])
def test_plain_version_matches_pallas_interpret(case, block_kv):
    b, s, hq, hkv, d, kind = case
    q, k, v = _qkv(b, s, s, hq, hkv, d, 0)
    jkw, tkw = _masks(kind, b, s)
    ref = np.asarray(jk4(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_kv=block_kv,
                         interpret=True, **jkw))
    out = k4.flash_attention_int8_reference(torch.from_numpy(q), torch.from_numpy(k),
                                            torch.from_numpy(v), block_kv=block_kv, **tkw).numpy()
    assert _rel(out, ref) < REL_L2, _rel(out, ref)


def test_multi_group_pad_and_near_k4_not_k3():
    """1,024 keys = two 512-key groups with a pad mask: the plain version at
    the default group size against JAX K4, and several times nearer JAX K4
    than JAX K3 on the same inputs (the int8 p v error shows)."""
    q, k, v = _qkv(1, 1024, 1024, 2, 2, 128, 1)
    pm = np.ones((1, 1024), bool)
    pm[:, 500:700] = False
    jq, jk, jv, jpm = (jnp.asarray(x) for x in (q, k, v, pm))
    ref = np.asarray(jk4(jq, jk, jv, pad_mask=jpm, interpret=True))
    ref_k3 = np.asarray(jk3(jq, jk, jv, pad_mask=jpm, interpret=True))
    out = k4.flash_attention_int8(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  pad_mask=torch.from_numpy(pm)).numpy()
    rel, rel_k3 = _rel(out, ref), _rel(out, ref_k3)
    assert rel < REL_L2, rel
    assert rel_k3 > MIN_RATIO * REL_L2, (rel, rel_k3)


def test_fully_masked_row_gives_zero_in_both():
    q, k, v = _qkv(2, 512, 512, 2, 2, 64, 2)
    pm = np.ones((2, 512), bool)
    pm[1] = False
    ref = np.asarray(jk4(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pad_mask=jnp.asarray(pm),
                         interpret=True))
    out = k4.flash_attention_int8(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  pad_mask=torch.from_numpy(pm)).numpy()
    assert (ref[1] == 0).all() and (out[1] == 0).all()
    assert _rel(out[0], ref[0]) < REL_L2


@pytest.mark.parametrize("kind", ["pad", "causal"])
def test_length_contract_ragged(kind):
    """A ragged length (700, e.g. the runtime's joint lengths that are not a
    multiple of 512) equals JAX K4 on the input zero-padded to 1,024 with
    the padded keys masked, cut back to 700 rows."""
    s, sp = 700, 1024
    q, k, v = _qkv(1, s, s, 2, 2, 64, 3)
    jkw, tkw = _masks(kind, 1, s)
    keep = np.zeros((1, sp), bool)
    keep[:, :s] = True
    if kind == "pad":
        keep[:, :s] &= np.asarray(jkw["pad_mask"])
    pad = ((0, 0), (0, sp - s), (0, 0), (0, 0))
    ref = np.asarray(jk4(*(jnp.asarray(np.pad(x, pad)) for x in (q, k, v)),
                         pad_mask=jnp.asarray(keep), causal=kind == "causal",
                         interpret=True))[:, :s]
    out = k4.flash_attention_int8(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  **tkw).numpy()
    assert _rel(out, ref) < REL_L2, _rel(out, ref)


def test_v_quantization_matches_jax_wrapper():
    """Per (batch, kv head, feature) over all keys, pad keys included."""
    v = np.random.default_rng(4).standard_normal((2, 40, 3, 64)).astype(np.float32)
    v[1, :, 2, 5] = 0.0
    vt = jnp.asarray(v).transpose(0, 2, 1, 3)
    s_ref = jnp.maximum(jnp.max(jnp.abs(vt), axis=-2, keepdims=True), 1e-8) / 127.0
    q_ref = jnp.clip(jnp.round(vt / s_ref), -127, 127).astype(jnp.int8)
    qi, s = k4.quantize_v_columns(torch.from_numpy(v))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(q_ref.transpose(0, 2, 1, 3)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref[:, :, 0]))


def test_front_end_routes():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 96, 96, 4, 2, 64, 5))
    pm = torch.ones(1, 96, dtype=torch.bool)
    pm[:, 90:] = False
    torch.testing.assert_close(
        tattn.dot_product_attention(q, k, v, pad_mask=pm, causal=True, impl="pallas_int8"),
        k4.flash_attention_int8(q, k, v, pad_mask=pm, causal=True), rtol=0, atol=0)
    with pytest.raises(ValueError, match="no bias"):
        tattn.dot_product_attention(q, k, v, bias=torch.zeros(1, 1, 96, 96), impl="pallas_int8")
    with pytest.raises(ValueError, match="impl"):
        tattn.dot_product_attention(q, k, v, impl="ring")


def test_cuda_tensor_goes_to_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(k4, "_flash_attention_int8_cuda",
                        lambda q, k, v, **kw: calls.append(q) or "kernel")
    monkeypatch.setattr(k4, "flash_attention_int8_reference",
                        lambda *a, **kw: pytest.fail("a CUDA tensor reached the plain version"))
    q = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert k4.flash_attention_int8(q, q, q) == "kernel" and calls == [q]


def test_kernel_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 8, 2, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        k4._flash_attention_int8_cuda(q, q, q, causal=False, q_segment_ids=None,
                                      kv_segment_ids=None, pad_mask=None, scale=None)
    with pytest.raises(ValueError, match="GQA"):
        k4.flash_attention_int8(torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 2, 64),
                                torch.zeros(1, 8, 2, 64))
