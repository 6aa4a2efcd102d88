"""Weight quantization of a param tree: int8 weight-only, int4 weight-only
and W8A8.

A copy of `gpt_image_edit_tpu.utils.quantize` over torch tensors, with the
same formats, so a tree quantized by either package means the same thing:

- weight-only int8: kernel (..., in, out) -> {"q": int8 (..., in, out),
  "scale": fp32 (..., 1, out)}, per output channel, dequantized to the
  activation dtype at use;
- W8A8: the same codes under "q_w8a8"; `models.common.linear` quantizes
  each activation row to int8 on the fly and runs an int8 x int8 -> int32
  product;
- int4: {"q4": uint8 (..., in/2, out), "scale4": fp32 (..., in/64, 1,
  out)}, two offset-8 nibbles per byte (low = even input row), one scale
  per 64-input group and output channel.

W8A8 codes keep the (..., in, out) shape but are stored with the input
axis contiguous (`w8a8_layout`: per layer the memory of the (out, in)
transpose). torch._int_mm then hands cuBLASLt the operand order its int8
tensor-core kernels take; with row-major (in, out) codes it falls back to a
compatibility kernel several times slower on the H100 (PERF.md).

A stacked kernel (L, in, out) is quantized one layer at a time, which gives
the same codes (every scale is per layer) and keeps the fp32 transient to
one layer: the whole dual-block `ff.in` stack of FLUX, (19, 3072, 12288),
would be 2.9 GB in fp32. Leaves stay on their device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

INT4_GROUP = 64  # input-channel group size for int4 scales


def _quantize_2d(kf: torch.Tensor, mode: str):
    """One (in, out) fp32 kernel -> (codes, scale)."""
    if mode == "int4":
        d_in, d_out = kf.shape
        grouped = kf.reshape(d_in // INT4_GROUP, INT4_GROUP, d_out)
        amax = grouped.abs().amax(dim=-2, keepdim=True)
        scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(grouped / scale), -7, 7).to(torch.int8).reshape(d_in, d_out)
        # two consecutive input rows per byte: low nibble = even row, high
        # nibble = odd row (offset-8 unsigned nibbles)
        u = (q + 8).to(torch.uint8)
        return u[0::2] | (u[1::2] << 4), scale
    amax = kf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(kf / scale), -127, 127).to(torch.int8), scale


def quantize_kernel(kernel: torch.Tensor, mode: str = "weight_only") -> dict:
    """(..., in, out) fp kernel -> {'q' | 'q_w8a8': int8, 'scale': fp32
    (..., 1, out)} or, for mode="int4", {'q4': uint8 (..., in/2, out),
    'scale4': fp32 (..., in/64, 1, out)}; per layer for stacked kernels."""
    if mode not in ("weight_only", "w8a8", "int4"):
        raise ValueError(f"unknown quantize mode {mode!r} (weight_only | w8a8 | int4)")
    *lead, d_in, d_out = kernel.shape
    if mode == "int4" and d_in % INT4_GROUP:
        raise ValueError(f"int4 needs in_features divisible by {INT4_GROUP}, got {d_in}")
    flat = kernel.reshape(-1, d_in, d_out)
    codes = scales = None
    for i in range(flat.shape[0]):
        q, s = _quantize_2d(flat[i].float(), mode)
        if codes is None:
            n, shape = flat.shape[0], tuple(q.shape)
            if mode == "w8a8":  # allocated in w8a8_layout: no second copy
                codes = torch.empty((n,) + shape[::-1], dtype=q.dtype,
                                    device=q.device).transpose(-1, -2)
            else:
                codes = torch.empty((n,) + shape, dtype=q.dtype, device=q.device)
            scales = torch.empty((n,) + tuple(s.shape), dtype=s.dtype, device=s.device)
        codes[i], scales[i] = q, s
    codes = codes.reshape(*lead, *codes.shape[1:])
    scales = scales.reshape(*lead, *scales.shape[1:])
    if mode == "int4":
        return {"q4": codes, "scale4": scales}
    return {"q_w8a8" if mode == "w8a8" else "q": codes, "scale": scales}


def w8a8_layout(codes: torch.Tensor) -> torch.Tensor:
    """The same (..., in, out) int8 codes with the input axis contiguous."""
    return codes.transpose(-1, -2).contiguous().transpose(-1, -2)


def dequantize_kernel_int4(qk: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{'q4', 'scale4'} -> (..., in, out) dense kernel."""
    packed, scale = qk["q4"], qk["scale4"]
    *lead, half_in, d_out = packed.shape
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * half_in, d_out)  # even rows from lo
    grouped = q.reshape(*lead, (2 * half_in) // INT4_GROUP, INT4_GROUP, d_out).float()
    return (grouped * scale).reshape(*lead, 2 * half_in, d_out).to(dtype)


def dequantize_kernel(qk: dict, dtype=torch.bfloat16) -> torch.Tensor:
    if "q4" in qk:
        return dequantize_kernel_int4(qk, dtype)
    q = qk["q"] if "q" in qk else qk["q_w8a8"]
    return (q.float() * qk["scale"]).to(dtype)


def quantize_params(
    params: Any,
    *,
    min_size: int = 1 << 20,
    path_filter: Optional[Callable[[str], bool]] = None,
    mode: str = "weight_only",
    mode_for: Optional[Callable[[str], Optional[str]]] = None,
) -> Any:
    """Quantize every 'kernel' leaf of at least `min_size` elements (and
    2 or more dims), in place, and return the tree; `models.common.linear`
    takes the quantized kernels. `mode_for(path)` overrides `mode` per
    kernel ("w8a8", "weight_only", "int4" or None to keep it as it is);
    paths are "/"-joined keys and list indices, as in the JAX package.

    Each quantized kernel replaces its full-precision one in the given tree
    as soon as it exists, so quantizing a model on the card needs room for
    one layer's fp32 transient beyond the model, not a second model. A
    caller that keeps the full-precision tree passes a copy of it."""

    def convert(path: str, leaf):
        leaf_mode = mode if mode_for is None else mode_for(path)
        if (leaf_mode is None or not path.endswith("kernel") or not torch.is_tensor(leaf)
                or leaf.dim() < 2 or leaf.numel() < min_size
                or (path_filter is not None and not path_filter(path))):
            return leaf
        if leaf_mode == "int4" and leaf.shape[-2] % INT4_GROUP:
            # int4 grouping needs in_features % 64 == 0; odd-shaped kernels
            # (tiny configs, patch embeds) take int8 instead
            leaf_mode = "weight_only"
        return quantize_kernel(leaf, leaf_mode)

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in list(node):
                node[k] = walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, list):
            for i in range(len(node)):
                node[i] = walk(node[i], f"{prefix}/{i}" if prefix else str(i))
        else:
            return convert(prefix, node)
        return node

    return walk(params, "")


def params_nbytes(params) -> int:
    """Bytes of every tensor leaf of a tree."""
    if isinstance(params, dict):
        return sum(params_nbytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(params_nbytes(v) for v in params)
    return params.numel() * params.element_size() if torch.is_tensor(params) else 0
