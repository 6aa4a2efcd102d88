"""Param-tree building blocks shared by the port's models.

Counterpart of `gpt_image_edit_tpu.models.common`. A model is a pair of
functions over a nested dict of tensors, laid out as in the JAX package:
linear kernels are (in_features, out_features) so a forward matmul is
`x @ w`, and per-layer block weights are stacked on a leading layer axis.
Convolution kernels are the one exception: the port keeps them OIHW, the
layout PyTorch's convolution takes (`utils.convert.from_jax` turns JAX's
HWIO into OIHW once, at load).

A kernel may be a tensor or a quantized dict (`utils.quantize`): weight-only
int8/int4 kernels are dequantized at use; W8A8 kernels take int8 activation
rows (quantized on the fly, or as QuantRows from K2) into an int8 x int8 ->
int32 product on `torch._int_mm` with the JAX package's bf16 epilogue.
Large products go to `torch.matmul`/`torch._int_mm`, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import os
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from gpt_image_edit_tpu_torch.ops.kernels.fused_quant import ln_modulate_quant_rows
from gpt_image_edit_tpu_torch.ops.norms import layer_norm, modulate
from gpt_image_edit_tpu_torch.ops.quant import quantize_rows
from gpt_image_edit_tpu_torch.utils.quantize import dequantize_kernel

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# init: every leaf is made directly on `device` in `dtype` from `generator`
# --------------------------------------------------------------------------

def _uniform(shape, bound: float, *, generator, device, dtype) -> torch.Tensor:
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.uniform_(-bound, bound, generator=generator)


def linear_init(generator, in_features: int, out_features: int, *, device, dtype,
                layers: Optional[int] = None, bias: bool = True) -> Params:
    """Uniform(+-in**-0.5) (in, out) kernel and zero bias, as the JAX
    `linear_init`; `layers` stacks that many on a leading axis."""
    lead = () if layers is None else (layers,)
    p: Params = {
        "kernel": _uniform(lead + (in_features, out_features), in_features ** -0.5,
                           generator=generator, device=device, dtype=dtype)
    }
    if bias:
        p["bias"] = torch.zeros(lead + (out_features,), device=device, dtype=dtype)
    return p


def conv2d_init(generator, in_ch: int, out_ch: int, kernel: int, *, device, dtype) -> Params:
    """Uniform(+-fan_in**-0.5) OIHW kernel and zero bias."""
    return {
        "kernel": _uniform((out_ch, in_ch, kernel, kernel), (in_ch * kernel * kernel) ** -0.5,
                           generator=generator, device=device, dtype=dtype),
        "bias": torch.zeros(out_ch, device=device, dtype=dtype),
    }


def group_norm_init(c: int, *, device, dtype) -> Params:
    return {"scale": torch.ones(c, device=device, dtype=dtype),
            "bias": torch.zeros(c, device=device, dtype=dtype)}


def rms_weight_init(c: int, *, device, dtype, layers: Optional[int] = None) -> Params:
    lead = () if layers is None else (layers,)
    return {"scale": torch.ones(lead + (c,), device=device, dtype=dtype)}


def layer_norm_init(c: int, *, device, dtype, layers: Optional[int] = None) -> Params:
    lead = () if layers is None else (layers,)
    return {"scale": torch.ones(lead + (c,), device=device, dtype=dtype),
            "bias": torch.zeros(lead + (c,), device=device, dtype=dtype)}


def normal_init(generator, shape, std: float, *, device, dtype) -> torch.Tensor:
    """N(0, std^2) leaves (embedding tables), as the JAX inits draw them."""
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.normal_(0.0, std, generator=generator)


def layer_slice(tree, i: int):
    """Layer i of a tree whose leaves are stacked on a leading layer axis."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


# --------------------------------------------------------------------------
# forward: linear layers over plain, weight-only (int8 / int4) and W8A8 kernels
# --------------------------------------------------------------------------

def _is_w8a8(kernel) -> bool:
    return isinstance(kernel, dict) and "q_w8a8" in kernel


def _int_mm(qx: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) exact int32 products. On the card
    torch._int_mm refuses 16 rows or fewer and cuBLASLt refuses some row
    counts that are not a multiple of 8 (17 rows at K = 64), so the rows
    are padded with zeros to a multiple of 8 and at least 32, which is
    exact."""
    m = qx.shape[0]
    if qx.is_cuda and (m < 32 or m % 8):
        rows = max(32, -(-m // 8) * 8)
        pad = qx.new_zeros(rows - m, qx.shape[1])
        return torch._int_mm(torch.cat([qx, pad]), q)[:m]
    return torch._int_mm(qx, q)


def _epilogue(acc: torch.Tensor, s_x: torch.Tensor, scale: torch.Tensor, out_dtype):
    """int32 products -> out_dtype: acc * s_x * scale in bf16, in that order
    (the JAX package's serving epilogue), or in fp32 when
    GIE_W8A8_EPILOGUE=f32."""
    if os.environ.get("GIE_W8A8_EPILOGUE", "bf16") == "f32":
        return (acc.float() * s_x * scale.float()).to(out_dtype)
    ep = torch.bfloat16
    return (acc.to(ep) * s_x.to(ep) * scale.to(ep)).to(out_dtype)


def _w8a8_matmul(kernel: Params, qx: torch.Tensor, s_x: torch.Tensor, out_dtype) -> torch.Tensor:
    """int8 x int8 -> int32 product on the last axis of qx, then the dequant
    epilogue (no bias)."""
    q = kernel["q_w8a8"]
    acc = _int_mm(qx.reshape(-1, qx.shape[-1]), q).reshape(*qx.shape[:-1], q.shape[-1])
    return _epilogue(acc, s_x, kernel["scale"][..., 0, :], out_dtype)


class QuantRows(NamedTuple):
    """Pre-quantized activation rows (int8 + per-row scale) standing in for
    the bf16 tensor as a `linear`/`linear_multi` input, as K2 (the fused
    ln+modulate+quant kernel) makes them: the modulated tensor never exists
    in bf16."""

    qx: torch.Tensor     # int8 (B, S, D)
    s_x: torch.Tensor    # f32 (B, S, 1)
    out_dtype: torch.dtype  # activation dtype for the dequant epilogue

    @property
    def shape(self):
        return self.qx.shape


def _fuse_mod_quant_mode() -> str:
    """off | on | interpret, from GIE_FUSE_MOD_QUANT (default on)."""
    v = os.environ.get("GIE_FUSE_MOD_QUANT", "1")
    return {"0": "off", "1": "on"}.get(v, v)


_FUSE_MODES = ("env", "on", "off", "interpret")


def ln_modulate_quant(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, probe: Params,
                      *, mode: str = "env", eps: float = 1e-6):
    """Block prologue `modulate(layer_norm(x), shift, scale)` for a W8A8
    consumer. `probe` is one of the consuming linear params: when its kernel
    is W8A8 and the mode is not "off", K2 (`ops.kernels.fused_quant`)
    returns QuantRows in one pass; otherwise this returns the modulated
    tensor. `mode` is FluxConfig.fuse_mod_quant (see there); "env" reads
    GIE_FUSE_MOD_QUANT."""
    if mode not in _FUSE_MODES:
        raise ValueError(f"fuse_mod_quant={mode!r}; want one of {_FUSE_MODES}")
    if mode == "env":
        mode = _fuse_mod_quant_mode()
    if _is_w8a8(probe["kernel"]) and mode != "off" and x.dim() == 3:
        qx, s_x = ln_modulate_quant_rows(x, shift, scale, eps=eps)
        return QuantRows(qx, s_x, x.dtype)
    return modulate(layer_norm(x, eps=eps), shift, scale)


def _dense_kernel(kernel, dtype) -> torch.Tensor:
    """A plain or weight-only (int8 'q' / int4 'q4') kernel in `dtype`."""
    if isinstance(kernel, dict):
        return dequantize_kernel(kernel, dtype)
    return kernel.to(dtype)


def linear(p: Params, x) -> torch.Tensor:
    kernel = p["kernel"]
    if isinstance(x, QuantRows):
        if not _is_w8a8(kernel):
            raise TypeError("a QuantRows input needs a W8A8 kernel")
        y = _w8a8_matmul(kernel, x.qx, x.s_x, x.out_dtype)
        dtype = x.out_dtype
    elif _is_w8a8(kernel):
        # W8A8: dynamic per-row activation quant, int8 product, dequant
        y = _w8a8_matmul(kernel, *quantize_rows(x), x.dtype)
        dtype = x.dtype
    else:
        y = torch.matmul(x, _dense_kernel(kernel, x.dtype))
        dtype = x.dtype
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def linear_multi(ps, x):
    """Several linear heads on ONE activation tensor. For W8A8 kernels the
    activation is quantized once and shared by every head (the same codes
    as per-head `linear`)."""
    if isinstance(x, QuantRows):
        shared, dtype = (x.qx, x.s_x), x.out_dtype
    else:
        shared, dtype = None, x.dtype
    outs = []
    for p in ps:
        if _is_w8a8(p["kernel"]):
            if shared is None:
                shared = quantize_rows(x)
            y = _w8a8_matmul(p["kernel"], *shared, dtype)
            if "bias" in p:
                y = y + p["bias"].to(dtype)
            outs.append(y)
        else:
            if isinstance(x, QuantRows):
                raise TypeError("a QuantRows input needs every head W8A8")
            outs.append(linear(p, x))
    return outs


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


# Upper bound of |gelu(x)| over x <= 0 for the tanh approximation (the
# minimum is -0.17001 at x ~ -0.7517), rounded up so the derived int8 scale
# never underestimates the row's absmax.
_GELU_TANH_MIN = 0.1701


def quantize_gelu_rows(pre: torch.Tensor):
    """Per-row int8 quantization of gelu(pre) with the scale taken from the
    PRE-gelu row max: gelu is increasing above its dip and bounded by 0.17
    in magnitude below it, so max(gelu(rowmax), 0.1701) >= absmax(gelu(row)),
    and one pass over gelu suffices."""
    pre_f = pre.float()
    rowmax = pre_f.amax(dim=-1, keepdim=True)
    s = torch.clamp_min(gelu_tanh(rowmax), _GELU_TANH_MIN) / 127.0
    q = torch.clamp(torch.round(gelu_tanh(pre_f) / s), -127, 127).to(torch.int8)
    return q, s


def linear_gelu(p: Params, pre: torch.Tensor) -> torch.Tensor:
    """`linear(p, gelu(pre))` (tanh-approximate gelu), with the one-pass
    gelu quantization when the kernel is W8A8."""
    if not _is_w8a8(p["kernel"]):
        return linear(p, gelu_tanh(pre))
    y = _w8a8_matmul(p["kernel"], *quantize_gelu_rows(pre), pre.dtype)
    if "bias" in p:
        y = y + p["bias"].to(pre.dtype)
    return y


def linear_concat(p: Params, parts) -> torch.Tensor:
    """`concat(parts, -1) @ kernel`; a part given as ("gelu", pre) stands
    for gelu(pre). With a W8A8 kernel the product is split per part: each
    part gets its own row scales (a gelu part through quantize_gelu_rows)
    and the partial products are summed after their epilogues."""
    kernel = p["kernel"]
    if not _is_w8a8(kernel):
        parts = [gelu_tanh(x[1]) if isinstance(x, tuple) else x for x in parts]
        return linear(p, torch.cat(parts, dim=-1))
    off, y = 0, None
    for x in parts:
        if isinstance(x, tuple):
            x = x[1]
            qx, s_x = quantize_gelu_rows(x)
        else:
            qx, s_x = quantize_rows(x)
        width = x.shape[-1]
        w = {"q_w8a8": kernel["q_w8a8"][off:off + width], "scale": kernel["scale"]}
        part = _w8a8_matmul(w, qx, s_x, x.dtype)
        y = part if y is None else y + part
        off += width
    if off != kernel["q_w8a8"].shape[0]:
        raise ValueError(f"parts span {off} inputs, the kernel {kernel['q_w8a8'].shape[0]}")
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def adaln_stacked(p: Params, silu_temb: torch.Tensor, chunks: int) -> torch.Tensor:
    """All-layers adaLN modulation vectors.

    p: stacked per-layer linear params — kernel (L, in, C) (plain, int8
    weight-only, int4 or W8A8), bias (L, C). silu_temb: (B, in). Returns
    (L, chunks, B, C // chunks), chunk i == out[..., i*d:(i+1)*d] of the
    per-layer linear. The W8A8 branch quantizes silu_temb once and runs one
    int8 product per layer on that layer's (in, C) codes (no copy of the
    stack); the weight-only branches dequantize one layer at a time.
    """
    kernel = p["kernel"]
    if _is_w8a8(kernel):
        qx, s_x = quantize_rows(silu_temb)
        acc = torch.stack([_int_mm(qx, kernel["q_w8a8"][i])
                           for i in range(kernel["q_w8a8"].shape[0])])          # (L, B, C)
        y = _epilogue(acc, s_x[None], kernel["scale"], silu_temb.dtype)          # (L, 1, C) scale
        if "bias" in p:
            y = y + p["bias"].to(y.dtype)[:, None, :]
    elif isinstance(kernel, dict):
        # weight-only: one layer's kernel dequantized at a time
        def layer(tree, i):
            return {k: layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]

        n_layers = next(iter(kernel.values())).shape[0]
        y = torch.stack([linear(layer(p, i), silu_temb) for i in range(n_layers)])   # (L, B, C)
    else:
        y = torch.einsum("bi,lic->lbc", silu_temb, kernel.to(silu_temb.dtype))
        if "bias" in p:
            y = y + p["bias"].to(y.dtype)[:, None, :]
    n_layers, b, c = y.shape
    d = c // chunks
    return y.reshape(n_layers, b, chunks, d).permute(0, 2, 1, 3)


def conv2d(p: Params, x: torch.Tensor, *, stride: int = 1, padding="SAME") -> torch.Tensor:
    """NHWC conv with an OIHW kernel. padding: 'SAME', 'VALID', or explicit
    [(lo, hi), (lo, hi)] for (H, W)."""
    kernel = p["kernel"].to(x.dtype)
    k = kernel.shape[-1]
    xc = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory (channels_last)
    if padding == "SAME":
        if stride != 1 or k % 2 == 0:
            raise NotImplementedError("SAME padding is ported for odd kernels at stride 1")
        pad = k // 2
    elif padding == "VALID":
        pad = 0
    else:
        (h_lo, h_hi), (w_lo, w_hi) = padding
        xc = F.pad(xc, (w_lo, w_hi, h_lo, h_hi))
        pad = 0
    bias = p["bias"].to(x.dtype) if "bias" in p else None
    y = F.conv2d(xc, kernel, bias, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def group_norm(p: Params, x: torch.Tensor, *, num_groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over NHWC, fp32 statistics."""
    dtype = x.dtype
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h * w, num_groups, c // num_groups)
    mean = torch.mean(xf, dim=(1, 3), keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=(1, 3), keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    xf = xf.reshape(b, h, w, c)
    xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(dtype)


def cast_floating(params, dtype, device=None):
    """Cast floating-point leaves to dtype, leave ints alone (same tree);
    every leaf moves to `device` when one is given."""
    if isinstance(params, dict):
        return {k: cast_floating(v, dtype, device) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_floating(v, dtype, device) for v in params]
    return params.to(device=device, dtype=dtype if params.is_floating_point() else None)


def first_leaf(params) -> torch.Tensor:
    """The first tensor of a param tree (its device and dtype stand for the tree)."""
    while isinstance(params, (dict, list)):
        params = next(iter(params.values())) if isinstance(params, dict) else params[0]
    return params
