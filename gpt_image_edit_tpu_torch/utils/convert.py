"""JAX parameter tree -> the port's tensors.

`from_jax` takes the JAX package's parameter tree (nested dicts and lists of
numpy arrays, or of arrays numpy can read) and returns the same tree of
torch tensors, for every model the port has (FLUX, the VAE, Qwen2.5-VL,
T5 and CLIP). Linear kernels stay (in, out) and
stacked block weights keep their leading layer axis; 4-D convolution
kernels turn from JAX's HWIO into the OIHW that PyTorch's convolution takes.
A quantized kernel (`utils.quantize`: a dict of int8/uint8 codes and fp32
scales under "kernel") crosses as it is: its leaves keep their dtypes,
shapes and values, whatever `dtype` asks for the rest of the tree (W8A8
codes are stored in `utils.quantize.w8a8_layout`).
The same converter serves the parity tests and, later, checkpoint loading.
"""

from __future__ import annotations

import numpy as np
import torch

from gpt_image_edit_tpu_torch.utils.platform import resolve_device
from gpt_image_edit_tpu_torch.utils.quantize import w8a8_layout


_QUANTIZED_KEYS = ("q", "q_w8a8", "q4")


def _leaf(name, x, device, dtype) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: widen exactly, narrow in torch
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if name == "kernel" and t.dim() == 4:
        t = t.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()


def from_jax(tree, device="cuda", dtype=None):
    """Same tree, torch tensors on `device`; floating leaves cast to `dtype`
    when given (ints kept). Raises if `device` is CUDA and there is none."""
    device = resolve_device(device)

    def walk(node, name=None):
        if isinstance(node, dict):
            if (any(k in node for k in _QUANTIZED_KEYS)
                    and not any(isinstance(v, dict) for v in node.values())):
                # codes + scales, unchanged (an attention dict also has a "q")
                out = {k: _leaf(k, v, device, None) for k, v in node.items()}
                if "q_w8a8" in out:
                    out["q_w8a8"] = w8a8_layout(out["q_w8a8"])
                return out
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return _leaf(name, node, device, dtype)

    return walk(tree)
