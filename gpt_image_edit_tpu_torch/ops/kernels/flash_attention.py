"""K1: flash-attention forward, a CUDA kernel written for Hopper (sm_90a).

Replaces `_resident_kernel` and `_grid_kernel` of
`gpt_image_edit_tpu/ops/pallas/flash_attention.py` (entry `flash_attention`).
The kernel is `csrc/flash_attention_fwd.cu`; its header says what bounds it
on the H100 (tensor-core throughput at the FLUX shape) and how the design
answers that.

`flash_attention` is the wrapper. A CPU tensor goes to the plain version,
`flash_attention_reference`, below. A CUDA tensor goes to the kernel: the
wrapper builds it on first use with `nvcc` from the package sources into
`build/kernels/` at the repo root (`ops.kernels.build`), launches it on the
current stream and raises if the build, the checks or the launch fail.
There is no fallback.

Masking contract (the Pallas kernel's, with the GPU masking its own ragged
edge instead of padding to a block multiple):
  - pad_mask (B, Skv): 1 = attend, 0 = masked key;
  - q_segment_ids / kv_segment_ids (B, Sq)/(B, Skv): attend within equal ids;
  - causal: end-aligned, key j visible to query i iff j <= i + Skv - Sq;
  - bias: additive fp32, broadcastable to (B, Hq, Sq, Skv);
  - GQA: Hq % Hkv == 0, q head h reads kv head h // (Hq // Hkv);
  - a query row that sees no key gives 0.
Where it differs from the JAX package: the Pallas kernel's causal diagonal
is start-aligned when Sq != Skv (the XLA path and this port are
end-aligned), and its pad-mask-only fast path averages v over a row whose
keys are all padding (this port gives 0, as its segment path does).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gpt_image_edit_tpu_torch.ops.kernels.build import kernel_function

_HEAD_DIMS = (64, 80, 128)  # CLIP/T5, the Qwen2.5-VL ViT, FLUX and the Qwen LM
_HEAD_CHUNK = 4  # heads per step of the plain version: (4, 8704, 8704) fp32 scores = 1.2 GB
_DTYPES = {torch.bfloat16: 0, torch.float16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_void_p])


def _check_masks(q, k, q_segment_ids, kv_segment_ids, pad_mask, bias):
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    skv, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq}, {hkv}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("give both q_segment_ids and kv_segment_ids, or neither")
    if q_segment_ids is not None and (tuple(q_segment_ids.shape) != (b, sq)
                                      or tuple(kv_segment_ids.shape) != (b, skv)):
        raise ValueError("segment ids must be (B, Sq) and (B, Skv)")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, skv):
        raise ValueError(f"pad_mask must be (B, Skv) = {(b, skv)}, got {tuple(pad_mask.shape)}")
    if bias is not None:
        torch.broadcast_shapes(tuple(bias.shape), (b, hq, sq, skv))
        if bias.dim() != 4:
            raise ValueError("bias must be 4-D, broadcastable to (B, Hq, Sq, Skv)")


def keep_mask(sq: int, skv: int, *, causal=False, q_segment_ids=None, kv_segment_ids=None,
              pad_mask=None, device=None) -> Optional[torch.Tensor]:
    """The masks as one (B or 1, 1, Sq, Skv) bool keep-mask, or None (the
    JAX package's `_build_mask`): causal end-aligned, equal segment ids,
    kept keys."""
    keep = None
    if causal:
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(skv, device=device)[None, :]
        keep = (cols <= rows + (skv - sq))[None, None]
    if q_segment_ids is not None:
        seg = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        keep = seg if keep is None else keep & seg
    if pad_mask is not None:
        pm = pad_mask.bool()[:, None, None, :]
        keep = pm if keep is None else keep & pm
    return keep


def flash_attention_reference(q, k, v, *, causal=False, q_segment_ids=None, kv_segment_ids=None,
                              pad_mask=None, bias=None, scale=None):
    """Plain PyTorch version of the kernel: masked fp32 softmax attention,
    chunked over heads so the (chunk, Sq, Skv) scores fit at S = 8,704."""
    _check_masks(q, k, q_segment_ids, kv_segment_ids, pad_mask, bias)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    dev = q.device
    keep = keep_mask(sq, skv, causal=causal, q_segment_ids=q_segment_ids,
                     kv_segment_ids=kv_segment_ids, pad_mask=pad_mask, device=dev)
    out = torch.empty(b, sq, hq, d, dtype=q.dtype, device=dev)
    for h0 in range(0, hq, _HEAD_CHUNK):
        h1 = min(h0 + _HEAD_CHUNK, hq)
        qh = q[:, :, h0:h1].float().permute(0, 2, 1, 3)                 # (B, h, Sq, D)
        kv_heads = torch.arange(h0, h1, device=dev) // group
        kh = k.float().index_select(2, kv_heads).permute(0, 2, 1, 3)    # (B, h, Skv, D)
        vh = v.float().index_select(2, kv_heads).permute(0, 2, 1, 3)
        s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
        if bias is not None:
            bh = bias if bias.shape[1] == 1 else bias[:, h0:h1]
            s = s + bh.float()
        if keep is not None:
            s = s.masked_fill(~keep, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)   # rows with no key
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p, vh) / torch.where(l == 0, torch.ones_like(l), l)
        out[:, :, h0:h1] = o.permute(0, 2, 1, 3).to(q.dtype)
    return out


def _flash_attention_cuda(q, k, v, *, causal, q_segment_ids, kv_segment_ids, pad_mask, bias, scale):
    """Check the inputs and launch the CUDA kernel; raises on anything it does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel takes CUDA tensors")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, S, H, D) tensor")
    if q.dtype not in _DTYPES:
        raise ValueError(f"the kernel takes bf16 or fp16, got {q.dtype}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    _check_masks(q, k, q_segment_ids, kv_segment_ids, pad_mask, bias)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built; the kernel takes {_HEAD_DIMS}")
    if scale is None:
        scale = d ** -0.5

    def on_device(t, dtype):
        if t.device != q.device:
            raise ValueError(f"mask on {t.device}, q on {q.device}")
        return t.to(dtype).contiguous()

    q_seg = kv_seg = keep = bias_t = None
    if q_segment_ids is not None:
        q_seg = on_device(q_segment_ids, torch.int32)
        kv_seg = on_device(kv_segment_ids, torch.int32)
    if pad_mask is not None:
        keep = on_device(pad_mask, torch.uint8)
    strides = (0, 0, 0, 0)
    if bias is not None:
        bias_t = on_device(bias, torch.float32)
        strides = tuple(0 if n == 1 else st for n, st in zip(bias_t.shape, bias_t.stride()))
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launch = kernel_function("flash_attention_fwd", "gie_flash_attention_fwd", _ARGTYPES)
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            ptr(q_seg), ptr(kv_seg), ptr(keep), ptr(bias_t), *strides,
            b, sq, skv, hq, hkv, d, _DTYPES[q.dtype], int(causal), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                    q_segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    pad_mask: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """BSHD attention: q (B, Sq, Hq, D), k/v (B, Skv, Hkv, D) -> (B, Sq, Hq, D).

    A CPU tensor takes the plain version; any other device takes the CUDA
    kernel, which raises if it cannot run. `flash_attention.launches`
    counts kernel launches."""
    kw = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              pad_mask=pad_mask, bias=bias, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, **kw)
    return _flash_attention_cuda(q, k, v, **kw)


flash_attention.launches = 0
