"""K3: flash-attention forward with int8 q k^T and bf16 p v, a CUDA kernel
written for Hopper (sm_90a).

Replaces `_resident_qk8_kernel` of
`gpt_image_edit_tpu/ops/pallas/flash_attention.py` (entry
`flash_attention_qk8`, the `--quantize w8a8-qk8` serving mode). The kernel
is `csrc/flash_attention_qk8.cu`; its header says what bounds it on the H100
(tensor-core throughput at the FLUX shape) and how the design answers that.
It shares K1's tile code (`csrc/flash_common.cuh`).

`flash_attention_qk8` is the wrapper. As in the JAX wrapper, q and k are
quantized per (batch, row, head) over d by plain tensor ops before the
kernel (`quantize_heads`); the kernel takes the int8 rows, their fp32
scales and bf16 v. A CPU tensor goes to the plain version,
`flash_attention_qk8_reference`, below; a CUDA tensor goes to the kernel,
built on first use, and the wrapper raises if the build, the checks or the
launch fail. There is no fallback.

Contract (the JAX front end's for "pallas_qk8"): BSHD, GQA, an optional kv
pad mask (B, Skv) with 1 = attend; no causal mask, segments or bias. Where
it differs from the JAX package, by design:
  - the JAX wrapper sends ragged or non-resident shapes (a length that is
    not a multiple of its 512 blocks, e.g. S = 8,752 of the 832x1248
    bucket) to bf16 XLA attention; the port runs K3 at every length, so on
    such shapes it differs from JAX by the int8 q k^T error;
  - a query row whose keys are all masked gives the mean of v in JAX (its
    -inf is finite) and 0 here, as in the port's K1. FLUX never has such a
    row: the image keys are always kept.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from gpt_image_edit_tpu_torch.ops.kernels.build import kernel_function

_HEAD_DIMS = (128,)  # FLUX's; the int8 product steps 32 of d at a time
_HEAD_CHUNK = 4  # heads per step of the plain version, as K1's
LOG2E = 1.4426950408889634
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def quantize_heads(x: torch.Tensor):
    """Per (batch, row, head) int8 over d: x (B, S, H, D) -> (int8 (B, S, H,
    D), fp32 scales (B, S, H)); scale = max(absmax, 1e-8) / 127 as in the
    JAX wrapper."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    return torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8), s


def _check(q, k, v, pad_mask):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if hq % k.shape[2]:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq}, {k.shape[2]}")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, k.shape[1]):
        raise ValueError(f"pad_mask must be (B, Skv) = {(b, k.shape[1])}, got {tuple(pad_mask.shape)}")


def flash_attention_qk8_reference(q, k, v, *, pad_mask=None, scale=None):
    """Plain PyTorch version of the kernel: q/k through `quantize_heads`,
    the int8 q k^T exact (integers below 2^24 in fp32, as long as d <= 1040),
    scores float(dot) * (qs * ks) * scale * log2(e) in base 2, p rounded to
    v's dtype for p v, the row sum in fp32; chunked over heads."""
    _check(q, k, v, pad_mask)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale2 = (d ** -0.5 if scale is None else scale) * LOG2E
    qi, qs = quantize_heads(q)
    ki, ks = quantize_heads(k)
    dev = q.device
    bias = torch.zeros(b, 1, 1, skv, dtype=torch.float32, device=dev)
    if pad_mask is not None:
        bias = bias.masked_fill(~pad_mask.bool()[:, None, None, :], float("-inf"))
    out = torch.empty(b, sq, hq, d, dtype=q.dtype, device=dev)
    for h0 in range(0, hq, _HEAD_CHUNK):
        h1 = min(h0 + _HEAD_CHUNK, hq)
        kv_heads = torch.arange(h0, h1, device=dev) // group
        qh = qi[:, :, h0:h1].float().permute(0, 2, 1, 3)                   # (B, h, Sq, D)
        kh = ki.index_select(2, kv_heads).float().permute(0, 2, 1, 3)      # (B, h, Skv, D)
        vh = v.index_select(2, kv_heads).float().permute(0, 2, 1, 3)
        qsh = qs[:, :, h0:h1].permute(0, 2, 1)[..., None]                  # (B, h, Sq, 1)
        ksh = ks.index_select(2, kv_heads).permute(0, 2, 1)[:, :, None, :]  # (B, h, 1, Skv)
        s = torch.matmul(qh, kh.transpose(-1, -2)) * (qsh * ksh) * scale2 + bias
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)   # rows with no key
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.to(v.dtype).float(), vh) / torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, h0:h1] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _flash_attention_qk8_cuda(q, k, v, *, pad_mask, scale):
    """Quantize q/k, check the inputs and launch the CUDA kernel; raises on
    anything it does not take."""
    _check(q, k, v, pad_mask)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the kernel takes bf16 q, k and v; {name} is {t.dtype}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes {_HEAD_DIMS}")
    keep = None
    if pad_mask is not None:
        if pad_mask.device != q.device:
            raise ValueError(f"pad_mask on {pad_mask.device}, q on {q.device}")
        keep = pad_mask.to(torch.uint8).contiguous()
    qi, qs = quantize_heads(q)
    ki, ks = quantize_heads(k)
    v = v.contiguous()
    scale2 = (d ** -0.5 if scale is None else scale) * LOG2E
    if not math.isfinite(scale2):
        raise ValueError(f"scale {scale} is not finite")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launch = kernel_function("flash_attention_qk8", "gie_flash_attention_qk8", _ARGTYPES)
        err = launch(qi.data_ptr(), ki.data_ptr(), v.data_ptr(), out.data_ptr(), qs.data_ptr(),
                     ks.data_ptr(), None if keep is None else keep.data_ptr(),
                     b, sq, skv, hq, hkv, d, float(scale2), stream)
    if err != 0:
        raise RuntimeError(f"flash attention qk8 kernel launch failed: cudaError {err}")
    flash_attention_qk8.launches += 1
    return out


def flash_attention_qk8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        pad_mask: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """BSHD attention with int8 q k^T: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D)
    -> (B, Sq, Hq, D) in q's dtype.

    A CPU tensor takes the plain version; any other device takes the CUDA
    kernel, which raises if it cannot run. `flash_attention_qk8.launches`
    counts kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_qk8_reference(q, k, v, pad_mask=pad_mask, scale=scale)
    return _flash_attention_qk8_cuda(q, k, v, pad_mask=pad_mask, scale=scale)


flash_attention_qk8.launches = 0
