"""Port parity: K3, flash attention with int8 q k^T and bf16 p v, against
the Pallas kernel `flash_attention_qk8` in interpret mode (CPU), and the
attention front end's "pallas_qk8" route."""

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from gpt_image_edit_tpu.ops.pallas.flash_attention import flash_attention_qk8 as jqk8
from gpt_image_edit_tpu_torch.ops import attention as tattn
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention as fa
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention_qk8 as q8

torch.set_num_threads(2)


def _qkv(b, sq, skv, hq, hkv, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("case", [
    # (B, S, Hq, Hkv, D, padded keys): one KV block in the Pallas kernel
    (1, 384, 4, 4, 32, 28),     # the tiny FLUX joint attention with a text pad mask
    (2, 256, 8, 2, 64, 0),      # GQA 8/2, no mask
    (1, 512, 4, 4, 128, 100),   # d = 128, the FLUX head dim
])
def test_plain_version_matches_pallas_interpret(case):
    b, s, hq, hkv, d, npad = case
    q, k, v = _qkv(b, s, s, hq, hkv, d, 0)
    pad = np.ones((b, s), bool)
    pad[:, 10:10 + npad] = False
    mask = pad if npad else None
    ref = np.asarray(jqk8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pad_mask=None if mask is None else jnp.asarray(mask), interpret=True))
    out = q8.flash_attention_qk8(_t(q), _t(k), _t(v),
                                 pad_mask=None if mask is None else torch.from_numpy(mask)).numpy()
    # fp32 inputs: the same int8 codes and exact int32 dots; only the fp32
    # softmax sums run in another order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_plain_version_bf16_v_rounds_p():
    """With bf16 q/k/v the Pallas kernel rounds p to bf16 before p v; so does
    the plain version (an fp32 reference of the same scores differs)."""
    q, k, v = _qkv(1, 256, 256, 2, 2, 64, 1, ml_dtypes.bfloat16)
    ref = np.asarray(jqk8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
                     .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x.astype(np.float32)).bfloat16() for x in (q, k, v))
    out = q8.flash_attention_qk8(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    # the output is bf16: one bf16 ulp of the largest values
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2.0 ** -7)


def test_two_kv_blocks_online_softmax():
    """Skv = 1,024 runs as two 512-key blocks in the Pallas kernel (an
    online softmax); the plain version takes the whole row at once."""
    q, k, v = _qkv(1, 1024, 1024, 2, 2, 64, 2)
    pad = np.ones((1, 1024), bool)
    pad[:, 500:520] = False
    ref = np.asarray(jqk8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pad_mask=jnp.asarray(pad), interpret=True))
    out = q8.flash_attention_qk8(_t(q), _t(k), _t(v), pad_mask=torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_quantize_heads_matches_jax_wrapper():
    """The JAX wrapper's per-(batch, head, row) quantization, reproduced."""
    x = np.random.default_rng(3).standard_normal((2, 40, 3, 64)).astype(np.float32)
    x[0, 1, 2] = 0.0
    xt = jnp.asarray(x).transpose(0, 2, 1, 3)
    s_ref = jnp.maximum(jnp.max(jnp.abs(xt), axis=-1), 1e-8) / 127.0
    q_ref = jnp.clip(jnp.round(xt / s_ref[..., None]), -127, 127).astype(jnp.int8)
    qi, s = q8.quantize_heads(torch.from_numpy(x))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(q_ref.transpose(0, 2, 1, 3)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref.transpose(0, 2, 1)))


def test_fully_masked_row_gives_zero():
    """Where the port differs from JAX by design: a query row whose keys are
    all masked gives 0 (JAX: the mean of v, its -inf being finite)."""
    q, k, v = _qkv(2, 64, 64, 2, 2, 64, 4)
    pad = np.ones((2, 64), bool)
    pad[1] = False
    out = q8.flash_attention_qk8(_t(q), _t(k), _t(v), pad_mask=torch.from_numpy(pad))
    assert bool((out[1] == 0).all()) and bool(out[0].abs().sum() > 0)


def test_close_to_bf16_attention():
    """int8 q k^T is a small perturbation of K1's scores on RMS-normalized
    q/k (the FLUX case)."""
    q, k, v = _qkv(1, 256, 256, 4, 4, 128, 5)
    q /= np.sqrt((q ** 2).mean(-1, keepdims=True))
    k /= np.sqrt((k ** 2).mean(-1, keepdims=True))
    a = q8.flash_attention_qk8(_t(q), _t(k), _t(v))
    b = fa.flash_attention(_t(q), _t(k), _t(v))
    assert float((a - b).norm() / b.norm()) < 2e-2


def test_front_end_routes():
    q, k, v = (_t(x) for x in _qkv(1, 32, 32, 2, 2, 64, 6))
    pm = torch.ones(1, 32, dtype=torch.bool)
    torch.testing.assert_close(tattn.dot_product_attention(q, k, v, pad_mask=pm, impl="pallas_qk8"),
                               q8.flash_attention_qk8(q, k, v, pad_mask=pm), rtol=0, atol=0)
    for bad in (dict(causal=True), dict(bias=torch.zeros(1, 1, 32, 32)),
                dict(q_segment_ids=pm.int(), kv_segment_ids=pm.int())):
        with pytest.raises(ValueError, match="pad_mask only"):
            tattn.dot_product_attention(q, k, v, impl="pallas_qk8", **bad)
    with pytest.raises(ValueError):
        tattn.dot_product_attention(q, k, v, impl="xla")


def test_cuda_tensor_goes_to_kernel(monkeypatch):
    calls = []
    monkeypatch.setattr(q8, "_flash_attention_qk8_cuda",
                        lambda q, k, v, pad_mask, scale: calls.append(q) or "kernel")
    monkeypatch.setattr(q8, "flash_attention_qk8_reference",
                        lambda *a, **kw: pytest.fail("a CUDA tensor reached the plain version"))
    q = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert q8.flash_attention_qk8(q, q, q) == "kernel" and calls == [q]


def test_kernel_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        q8._flash_attention_qk8_cuda(q, q, q, pad_mask=None, scale=None)
    with pytest.raises(ValueError, match="GQA"):
        q8.flash_attention_qk8(torch.zeros(1, 8, 3, 64), torch.zeros(1, 8, 2, 64),
                               torch.zeros(1, 8, 2, 64))
