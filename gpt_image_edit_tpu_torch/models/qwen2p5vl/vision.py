"""Qwen2.5-VL vision tower (ViT with windowed attention + 2x2 patch merger).

Counterpart of `gpt_image_edit_tpu.models.qwen2p5vl.vision`, over the same
param tree (blocks stacked on a leading layer axis, (in, out) kernels).
What depends only on the patch grid (window reordering, window and
full-attention segment ids, rope tables) is computed on the host in numpy
(`vision_precompute`); the model sees dense gathers and segment-masked
attention, which runs through K1's segment path at head dim 80.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from gpt_image_edit_tpu_torch.models.common import (
    Params,
    layer_slice,
    linear,
    linear_init,
    linear_multi,
    rms_weight_init,
)
from gpt_image_edit_tpu_torch.models.qwen2p5vl.config import VisionConfig
from gpt_image_edit_tpu_torch.ops.attention import dot_product_attention
from gpt_image_edit_tpu_torch.ops.norms import rms_norm
from gpt_image_edit_tpu_torch.ops.rope import apply_rope_halves


# --------------------------------------------------------------------------
# host-side precompute (numpy; depends only on grid_thw)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class VisionAux:
    """Per-grid auxiliary arrays for one concatenated patch sequence."""

    window_order: np.ndarray   # (S,) gather order into window layout
    inverse_order: np.ndarray  # (S_merged,) restores the merger output order
    seg_full: np.ndarray       # (S,) segment id per token (per image), window layout
    seg_window: np.ndarray     # (S,) window segment id, window layout
    rope_cos: np.ndarray       # (S, head_dim), window layout
    rope_sin: np.ndarray       # (S, head_dim)


def vision_precompute(grid_thw: np.ndarray, cfg: VisionConfig) -> VisionAux:
    """Window reorder + segments + rope for concatenated images (HF
    `get_window_index` / `rot_pos_emb`: tokens arrive grouped in merge units
    of spatial_merge_size**2 consecutive patches)."""
    merge = cfg.spatial_merge_size
    unit = cfg.merge_unit
    win = cfg.window_size // merge // cfg.patch_size  # merged-cell window side

    window_order_units, seg_window_units, seg_full_units, hw_pos = [], [], [], []
    unit_base = 0
    window_id = 0
    for img_idx, (t, h, w) in enumerate(np.asarray(grid_thw)):
        gh, gw = h // merge, w // merge
        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        pad_h, pad_w = (-gh) % win, (-gw) % win
        padded = np.full((t, gh + pad_h, gw + pad_w), -1, dtype=np.int64)
        padded[:, :gh, :gw] = idx
        nwh, nww = (gh + pad_h) // win, (gw + pad_w) // win
        padded = padded.reshape(t, nwh, win, nww, win).transpose(0, 1, 3, 2, 4)
        for row in padded.reshape(t * nwh * nww, win * win):
            cells = row[row != -1]
            if cells.size == 0:
                continue
            window_order_units.append(cells + unit_base)
            seg_window_units.append(np.full(cells.size, window_id))
            seg_full_units.append(np.full(cells.size, img_idx))
            window_id += 1
        unit_base += t * gh * gw

        # rope ids per patch, original order: row-major over merge blocks
        hp = np.arange(h)[:, None].repeat(w, 1)
        hp = hp.reshape(gh, merge, gw, merge).transpose(0, 2, 1, 3).reshape(-1)
        wp = np.arange(w)[None, :].repeat(h, 0)
        wp = wp.reshape(gh, merge, gw, merge).transpose(0, 2, 1, 3).reshape(-1)
        hw_pos.append(np.tile(np.stack([hp, wp], axis=-1), (t, 1)))

    order_units = np.concatenate(window_order_units)
    hw_pos = np.concatenate(hw_pos, axis=0)
    order = (order_units[:, None] * unit + np.arange(unit)[None, :]).reshape(-1)

    half = cfg.head_dim // 2
    quarter = half // 2
    inv_freq = 1.0 / (10000.0 ** (np.arange(quarter, dtype=np.float64) * 2.0 / half))
    hw = hw_pos[order]
    freqs = np.concatenate([hw[:, 0:1] * inv_freq[None, :], hw[:, 1:2] * inv_freq[None, :]], -1)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return VisionAux(
        window_order=order.astype(np.int32),
        inverse_order=np.argsort(order_units, kind="stable").astype(np.int32),
        seg_full=np.repeat(np.concatenate(seg_full_units), unit).astype(np.int32),
        seg_window=np.repeat(np.concatenate(seg_window_units), unit).astype(np.int32),
        rope_cos=np.cos(emb).astype(np.float32),
        rope_sin=np.sin(emb).astype(np.float32),
    )


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def init(cfg: VisionConfig, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    """A random param tree in the JAX layout, made on `device` in `dtype`
    with the JAX init's distributions."""
    d, m, n = cfg.hidden_size, cfg.intermediate_size, cfg.depth
    kw = dict(device=device, dtype=dtype)

    def lin(i, o, layers=None, bias=True):
        return linear_init(generator, i, o, layers=layers, bias=bias, **kw)

    merged = d * cfg.merge_unit
    return {
        "patch_embed": lin(cfg.patch_dim, d, bias=False),
        "blocks": {
            "norm1": rms_weight_init(d, layers=n, **kw),
            "attn": {"qkv": lin(d, 3 * d, n), "proj": lin(d, d, n)},
            "norm2": rms_weight_init(d, layers=n, **kw),
            "mlp": {"gate": lin(d, m, n), "up": lin(d, m, n), "down": lin(m, d, n)},
        },
        "merger": {
            "ln_q": rms_weight_init(d, **kw),
            "fc1": lin(merged, merged),
            "fc2": lin(merged, cfg.out_hidden_size),
        },
    }


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def _block(p: Params, x, cos, sin, seg, cfg: VisionConfig):
    """x: (S, D), one concatenated sequence (batch of 1)."""
    s, d = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    xn = rms_norm(x, p["norm1"]["scale"], cfg.rms_eps)
    qkv = linear(p["attn"]["qkv"], xn).reshape(s, 3, h, hd)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    # halves rope over (1, H, S, D), then back to BSHD
    q = apply_rope_halves(q.transpose(0, 1)[None], cos, sin)[0].transpose(0, 1)[None]
    k = apply_rope_halves(k.transpose(0, 1)[None], cos, sin)[0].transpose(0, 1)[None]
    attn = dot_product_attention(q.contiguous(), k.contiguous(), v[None].contiguous(),
                                 q_segment_ids=seg[None], kv_segment_ids=seg[None])
    x = x + linear(p["attn"]["proj"], attn[0].reshape(s, d))
    xn = rms_norm(x, p["norm2"]["scale"], cfg.rms_eps)
    gate, up = linear_multi((p["mlp"]["gate"], p["mlp"]["up"]), xn)
    return x + linear(p["mlp"]["down"], F.silu(gate) * up)


def apply(params: Params, cfg: VisionConfig, pixel_patches: torch.Tensor,
          aux: VisionAux) -> torch.Tensor:
    """(S, patch_dim) flattened patches in the original order -> merged image
    embeddings (S / merge_unit, out_hidden_size) in the original merge-unit
    order."""
    dev = pixel_patches.device
    x = linear(params["patch_embed"], pixel_patches)
    x = x[torch.from_numpy(aux.window_order).long().to(dev)]
    cos = torch.from_numpy(aux.rope_cos).to(dev)
    sin = torch.from_numpy(aux.rope_sin).to(dev)
    seg_full = torch.from_numpy(aux.seg_full).to(dev)
    seg_window = torch.from_numpy(aux.seg_window).to(dev)
    full = set(int(i) for i in cfg.fullatt_block_indexes)
    for i in range(cfg.depth):
        x = _block(layer_slice(params["blocks"], i), x, cos, sin,
                   seg_full if i in full else seg_window, cfg)
    m = params["merger"]
    x = rms_norm(x, m["ln_q"]["scale"], cfg.rms_eps)
    x = x.reshape(-1, cfg.merge_unit * cfg.hidden_size)
    x = linear(m["fc2"], F.gelu(linear(m["fc1"], x), approximate="none"))
    return x[torch.from_numpy(aux.inverse_order).long().to(dev)]
