"""K2: fused LayerNorm + adaLN modulate + int8 row quantization, a CUDA
kernel written for Hopper (sm_90a).

Replaces `_kernel` of `gpt_image_edit_tpu/ops/pallas/fused_quant.py` (entry
`ln_modulate_quant_rows`), the prologue of every W8A8 FLUX block. The
kernel is `csrc/fused_quant.cu`; its header says what bounds it on the H100
(bytes: one bf16 read and one int8 write per element) and how the design
answers that.

`ln_modulate_quant_rows` is the wrapper: it returns
`quantize_rows(modulate(layer_norm(x, eps), shift, scale))` as (int8
(B, S, D), fp32 scales (B, S, 1)). A CPU tensor goes to the plain version,
`ln_modulate_quant_rows_reference`, below. A CUDA tensor goes to the kernel,
built on first use (`ops.kernels.build`); the wrapper raises if the build,
the checks or the launch fail. There is no fallback. Unlike the Pallas
kernel there is no row block, so any S runs (the TPU wrapper raises on an
S that is not a multiple of its block), with D up to 4096.
"""

from __future__ import annotations

import ctypes

import torch

from gpt_image_edit_tpu_torch.ops.kernels.build import kernel_function
from gpt_image_edit_tpu_torch.ops.norms import layer_norm, modulate
from gpt_image_edit_tpu_torch.ops.quant import quantize_rows

MAX_D = 4096  # the kernel holds a row in registers: 128 fp32 per lane
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]


def _check(x, shift, scale):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, D), got {tuple(x.shape)}")
    b, _, d = x.shape
    for name, t in (("shift", shift), ("scale", scale)):
        if tuple(t.shape) != (b, d):
            raise ValueError(f"{name} must be (B, D) = {(b, d)}, got {tuple(t.shape)}")


def ln_modulate_quant_rows_reference(x, shift, scale, *, eps: float = 1e-6):
    """Plain PyTorch version: the unfused chain, shift/scale in x's dtype as
    the kernel reads them."""
    _check(x, shift, scale)
    return quantize_rows(modulate(layer_norm(x, eps=eps), shift.to(x.dtype), scale.to(x.dtype)))


def _ln_modulate_quant_rows_cuda(x, shift, scale, *, eps):
    """Check the inputs and launch the CUDA kernel; raises on anything it does not take."""
    _check(x, shift, scale)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}; the kernel takes CUDA tensors")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 x, got {x.dtype}")
    b, s, d = x.shape
    if not 1 <= d <= MAX_D:
        raise ValueError(f"D = {d}; the kernel takes 1 <= D <= {MAX_D}")
    for name, t in (("shift", shift), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    x = x.contiguous()
    shift = shift.to(torch.bfloat16).contiguous()
    scale = scale.to(torch.bfloat16).contiguous()
    q = torch.empty(b, s, d, dtype=torch.int8, device=x.device)
    s_x = torch.empty(b, s, 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch = kernel_function("fused_quant", "gie_ln_modulate_quant", _ARGTYPES)
        err = launch(x.data_ptr(), shift.data_ptr(), scale.data_ptr(), q.data_ptr(),
                     s_x.data_ptr(), b, s, d, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"ln_modulate_quant kernel launch failed: cudaError {err}")
    ln_modulate_quant_rows.launches += 1
    return q, s_x


def ln_modulate_quant_rows(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor, *,
                           eps: float = 1e-6):
    """x (B, S, D), shift/scale (B, D) -> (int8 (B, S, D), fp32 (B, S, 1)).

    A CPU tensor takes the plain version; any other device takes the CUDA
    kernel, which raises if it cannot run. `ln_modulate_quant_rows.launches`
    counts kernel launches."""
    if x.device.type == "cpu":
        return ln_modulate_quant_rows_reference(x, shift, scale, eps=eps)
    return _ln_modulate_quant_rows_cuda(x, shift, scale, eps=eps)


ln_modulate_quant_rows.launches = 0
