"""K4: flash-attention forward with int8 q k^T and int8 p v, a CUDA kernel
written for Hopper (sm_90a).

Replaces `_resident_int8_kernel` of
`gpt_image_edit_tpu/ops/pallas/flash_attention.py` (entry
`flash_attention_int8`, the `--quantize w8a8-attn` serving mode). The kernel
is `csrc/flash_attention_int8.cu`; its header says what bounds it on the
H100 (int8 tensor-core operations and the exp2 of every score) and how the
design answers that.

`flash_attention_int8` is the wrapper. As in the JAX wrapper, q, k and v are
quantized by plain tensor ops before the kernel: q and k per (batch, row,
head) over d (`quantize_heads`, K3's), v per (batch, kv head, feature
column) over all keys (`quantize_v_columns`). The kernel takes the int8
codes, their fp32 scales and v transposed. A CPU tensor goes to the plain
version, `flash_attention_int8_reference`, below; a CUDA tensor goes to the
kernel, built on first use, and the wrapper raises if the build, the checks
or the launch fail. There is no fallback.

The function (the Pallas kernel's): scores float(q8 . k8) * (qs * ks) *
scale * log2(e) with masked keys at the finite -0.7 FLT_MAX; an online
base-2 softmax over groups of `block_kv` = 512 keys in which each group's
row max is taken over the whole group first, p is requantized to int8 per
row at the group's own max, p8 v runs in int32 and is folded in once per
group, and the row sum is of the fp32 p; out = (acc / l) * vs, and a row
that sees no key gives 0. Masks: a kv pad mask, segment ids, causal
(end-aligned, as the port's K1; the Pallas kernel is start-aligned, which
agrees when Sq == Skv), GQA.

The length contract: for any Sq and Skv this is what `flash_attention_int8`
computes when q, k and v are zero-padded along the sequence to a multiple
of 512, with the padded keys masked, cut back to Sq rows. Zero rows move no
scale and masked keys give p = 0, so on block-aligned shapes this is the
JAX function and on a ragged Skv the last group is shorter. (The JAX entry
asserts block-aligned lengths, which the runtime's joint lengths are not
for most prompt lengths.) The JAX front end drops `bias` on this route; the
port's front end raises on it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from gpt_image_edit_tpu_torch.ops.kernels.build import kernel_function
from gpt_image_edit_tpu_torch.ops.kernels.flash_attention import keep_mask
from gpt_image_edit_tpu_torch.ops.kernels.flash_attention_qk8 import LOG2E, quantize_heads

_HEAD_DIMS = (128,)  # FLUX's
BLOCK_KV = 512   # keys per p requantization group, the Pallas entry's block_kv
_TILE = 64       # the kernel's key tile: v^T rows are padded to a multiple of it
_HEAD_CHUNK = 4  # heads per step of the plain version
NEG_INF = -0.7 * 3.4028234663852886e38  # the Pallas kernel's finite mask value
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def quantize_v_columns(v: torch.Tensor):
    """Per (batch, kv head, feature) int8 over all Skv keys: v (B, Skv, H,
    D) -> (int8 (B, Skv, H, D), fp32 scales (B, H, D)); scale = max(absmax,
    1e-8) / 127 as in the JAX wrapper."""
    vf = v.float()
    s = torch.clamp_min(vf.abs().amax(dim=1), 1e-8) / 127.0
    return torch.clamp(torch.round(vf / s[:, None]), -127, 127).to(torch.int8), s


def _check(q, k, v, q_segment_ids, kv_segment_ids, pad_mask):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on batch or head dim")
    if hq % k.shape[2]:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got {hq}, {k.shape[2]}")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("give both q_segment_ids and kv_segment_ids, or neither")
    if q_segment_ids is not None and (tuple(q_segment_ids.shape) != (b, sq)
                                      or tuple(kv_segment_ids.shape) != (b, skv)):
        raise ValueError("segment ids must be (B, Sq) and (B, Skv)")
    if pad_mask is not None and tuple(pad_mask.shape) != (b, skv):
        raise ValueError(f"pad_mask must be (B, Skv) = {(b, skv)}, got {tuple(pad_mask.shape)}")


def flash_attention_int8_reference(q, k, v, *, causal=False, q_segment_ids=None,
                                   kv_segment_ids=None, pad_mask=None, scale=None,
                                   block_kv=BLOCK_KV):
    """Plain PyTorch version of the kernel, step for step the Pallas
    kernel's arithmetic (its int32 products are exact in fp32 here), over
    groups of `block_kv` keys; chunked over heads."""
    _check(q, k, v, q_segment_ids, kv_segment_ids, pad_mask)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    scale2 = (d ** -0.5 if scale is None else scale) * LOG2E
    qi, qs = quantize_heads(q)
    ki, ks = quantize_heads(k)
    vi, vs = quantize_v_columns(v)
    dev = q.device
    keep_all = keep_mask(sq, skv, causal=causal, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids, pad_mask=pad_mask, device=dev)
    out = torch.empty(b, sq, hq, d, dtype=q.dtype, device=dev)
    for h0 in range(0, hq, _HEAD_CHUNK):
        h1 = min(h0 + _HEAD_CHUNK, hq)
        kv_heads = torch.arange(h0, h1, device=dev) // group
        qh = qi[:, :, h0:h1].float().permute(0, 2, 1, 3)                   # (B, h, Sq, D)
        kh = ki.index_select(2, kv_heads).float().permute(0, 2, 1, 3)      # (B, h, Skv, D)
        vh = vi.index_select(2, kv_heads).float().permute(0, 2, 1, 3)
        qsh = qs[:, :, h0:h1].permute(0, 2, 1)[..., None]                  # (B, h, Sq, 1)
        ksh = ks.index_select(2, kv_heads).permute(0, 2, 1)[:, :, None, :]  # (B, h, 1, Skv)
        m = torch.full((b, h1 - h0, sq, 1), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, h1 - h0, sq, d, dtype=torch.float32, device=dev)
        for g0 in range(0, skv, block_kv):
            g1 = min(g0 + block_kv, skv)
            s = torch.matmul(qh, kh[:, :, g0:g1].transpose(-1, -2)) * (qsh * ksh[..., g0:g1]) * scale2
            keep = None if keep_all is None else keep_all[..., g0:g1]
            if keep is not None:
                s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            if keep is not None:
                p = torch.where(keep, p, 0.0)
            alpha = torch.exp2(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            p_max = torch.clamp_min(p.amax(dim=-1, keepdim=True), 1e-8)
            p8 = torch.round(p * (127.0 / p_max))
            acc = acc * alpha + torch.matmul(p8, vh[:, :, g0:g1]) * (p_max / 127.0)
            m = m_new
        l = torch.where(l == 0, torch.ones_like(l), l)
        vsh = vs.index_select(1, kv_heads)[:, :, None, :]                  # (B, h, 1, D)
        out[:, :, h0:h1] = ((acc / l) * vsh).permute(0, 2, 1, 3).to(q.dtype)
    return out


def _flash_attention_int8_cuda(q, k, v, *, causal, q_segment_ids, kv_segment_ids, pad_mask,
                               scale):
    """Quantize q, k and v, check the inputs and launch the CUDA kernel;
    raises on anything it does not take."""
    _check(q, k, v, q_segment_ids, kv_segment_ids, pad_mask)
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

    def on_device(t, dtype):
        if t.device != q.device:
            raise ValueError(f"mask on {t.device}, q on {q.device}")
        return t.to(dtype).contiguous()

    keep = None if pad_mask is None else on_device(pad_mask, torch.uint8)
    q_seg = kv_seg = None
    if q_segment_ids is not None:
        q_seg = on_device(q_segment_ids, torch.int32)
        kv_seg = on_device(kv_segment_ids, torch.int32)
    qi, qs = quantize_heads(q)
    ki, ks = quantize_heads(k)
    vi, vs = quantize_v_columns(v)
    # v transposed to (B, Hkv, D, Skv) for the kernel's p v operand, keys
    # padded with zeros to a multiple of its 64-key tile
    skv_pad = -(-skv // _TILE) * _TILE
    vt = torch.zeros(b, hkv, d, skv_pad, dtype=torch.int8, device=q.device)
    vt[..., :skv] = vi.permute(0, 2, 3, 1)
    scale2 = (d ** -0.5 if scale is None else scale) * LOG2E
    if not math.isfinite(scale2):
        raise ValueError(f"scale {scale} is not finite")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launch = kernel_function("flash_attention_int8", "gie_flash_attention_int8", _ARGTYPES)
        err = launch(qi.data_ptr(), ki.data_ptr(), vt.data_ptr(), out.data_ptr(), qs.data_ptr(),
                     ks.data_ptr(), vs.data_ptr(), ptr(keep), ptr(q_seg), ptr(kv_seg),
                     b, sq, skv, skv_pad, hq, hkv, d, int(causal), float(scale2), stream)
    if err != 0:
        raise RuntimeError(f"flash attention int8 kernel launch failed: cudaError {err}")
    flash_attention_int8.launches += 1
    return out


def flash_attention_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = False,
                         q_segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None,
                         pad_mask: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """BSHD attention with int8 q k^T and int8 p v: q (B, Sq, Hq, D), k/v
    (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's dtype.

    A CPU tensor takes the plain version (512-key groups); any other device
    takes the CUDA kernel, which raises if it cannot run.
    `flash_attention_int8.launches` counts kernel launches."""
    kw = dict(causal=causal, q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
              pad_mask=pad_mask, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_int8_reference(q, k, v, **kw)
    return _flash_attention_int8_cuda(q, k, v, **kw)


flash_attention_int8.launches = 0
