"""Param-tree building blocks shared by the port's models.

Counterpart of `gpt_image_edit_tpu.models.common`. A model is a pair of
functions over a nested dict of tensors, laid out as in the JAX package:
linear kernels are (in_features, out_features) so a forward matmul is
`x @ w`, and per-layer block weights are stacked on a leading layer axis.
Convolution kernels are the one exception: the port keeps them OIHW, the
layout PyTorch's convolution takes (`utils.convert.from_jax` turns JAX's
HWIO into OIHW once, at load).

Only the unquantized branches exist here: a quantized kernel dict (int8,
int4 or W8A8) raises NotImplementedError. Large products go to
`torch.matmul`, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

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


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _plain_kernel(p: Params) -> torch.Tensor:
    kernel = p["kernel"]
    if isinstance(kernel, dict):
        raise NotImplementedError(
            f"quantized kernel ({sorted(kernel)}) is not ported yet; serve bf16"
        )
    return kernel


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, _plain_kernel(p).to(x.dtype))
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def linear_multi(ps, x: torch.Tensor):
    """Several linear heads on ONE activation tensor (the JAX function
    shares the W8A8 activation quantization between them; unquantized it is
    one `linear` per head)."""
    return [linear(p, x) for p in ps]


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def linear_gelu(p: Params, pre: torch.Tensor) -> torch.Tensor:
    """`linear(p, gelu(pre))` (tanh-approximate gelu)."""
    return linear(p, gelu_tanh(pre))


def linear_concat(p: Params, parts) -> torch.Tensor:
    """`concat(parts, -1) @ kernel`; a part given as ("gelu", pre) stands
    for gelu(pre)."""
    _plain_kernel(p)
    parts = [gelu_tanh(x[1]) if isinstance(x, tuple) else x for x in parts]
    return linear(p, torch.cat(parts, dim=-1))


def adaln_stacked(p: Params, silu_temb: torch.Tensor, chunks: int) -> torch.Tensor:
    """All-layers adaLN modulation vectors in one batched matmul.

    p: stacked per-layer linear params — kernel (L, in, C), bias (L, C).
    silu_temb: (B, in). Returns (L, chunks, B, C // chunks), chunk i ==
    out[..., i*d:(i+1)*d] of the per-layer linear.
    """
    kernel = _plain_kernel(p)
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
