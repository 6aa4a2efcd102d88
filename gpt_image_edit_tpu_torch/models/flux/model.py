"""FLUX.1 MMDiT denoiser.

Counterpart of `gpt_image_edit_tpu.models.flux.model`, over the same param
tree: the 19 dual and 38 single blocks are stacked on a leading layer axis,
linear kernels are (in, out). The blocks run as a Python loop over that axis
(the JAX package scans them). The timestep arrives in [0, 1] and is scaled
x1000 inside; text rope ids are all-zero; the image token stream is
[target ++ reference] packed latents; in the joint attention the text
tokens come first.

Every linear layer takes a plain or a quantized kernel (`utils.quantize`).
With W8A8 kernels the block prologues `modulate(layer_norm(x))` go through
`ln_modulate_quant` (K2, per `cfg.fuse_mod_quant`) and hand int8 rows
straight to the consuming products; `cfg.attention_impl = "pallas_qk8"`
sends the attention to K3 (int8 q k^T) and "pallas_int8" to K4 (int8 q k^T
and int8 p v).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gpt_image_edit_tpu_torch.models.common import (
    Params,
    adaln_stacked,
    layer_slice,
    linear,
    linear_concat,
    linear_gelu,
    linear_init,
    linear_multi,
    ln_modulate_quant,
    rms_weight_init,
)
from gpt_image_edit_tpu_torch.models.flux.config import FluxConfig
from gpt_image_edit_tpu_torch.ops.attention import dot_product_attention
from gpt_image_edit_tpu_torch.ops.norms import layer_norm, modulate, rms_norm
from gpt_image_edit_tpu_torch.ops.rope import apply_rope_paired, flux_rope_freqs


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init(cfg: FluxConfig, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    """A random param tree in the JAX layout, every leaf made directly on
    `device` in `dtype` (no fp32 host copy of a 12B model): linear kernels
    Uniform(+-in**-0.5), zero biases, unit rms-norm scales — the JAX
    `init`'s distributions, from a torch.Generator's stream."""
    d, hd, mlp = cfg.inner_dim, cfg.attention_head_dim, cfg.mlp_dim
    kw = dict(device=device, dtype=dtype)

    def lin(i, o, layers=None):
        return linear_init(generator, i, o, layers=layers, **kw)

    def mlp_embed(i):
        return {"in": lin(i, d), "out": lin(d, d)}

    nd, ns = cfg.num_layers, cfg.num_single_layers
    dual = {
        "norm1": {"linear": lin(d, 6 * d, nd)},
        "norm1_context": {"linear": lin(d, 6 * d, nd)},
        "attn": {
            **{n: lin(d, d, nd) for n in ("to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                                          "add_v_proj", "to_out", "to_add_out")},
            **{n: rms_weight_init(hd, layers=nd, **kw)
               for n in ("norm_q", "norm_k", "norm_added_q", "norm_added_k")},
        },
        "ff": {"in": lin(d, mlp, nd), "out": lin(mlp, d, nd)},
        "ff_context": {"in": lin(d, mlp, nd), "out": lin(mlp, d, nd)},
    }
    single = {
        "norm": {"linear": lin(d, 3 * d, ns)},
        "proj_mlp": lin(d, mlp, ns),
        "attn": {
            **{n: lin(d, d, ns) for n in ("to_q", "to_k", "to_v")},
            **{n: rms_weight_init(hd, layers=ns, **kw) for n in ("norm_q", "norm_k")},
        },
        "proj_out": lin(d + mlp, d, ns),
    }
    params: Params = {
        "x_embedder": lin(cfg.in_channels, d),
        "context_embedder": lin(cfg.joint_attention_dim, d),
        "time_in": mlp_embed(cfg.time_embed_dim),
        "pooled_in": mlp_embed(cfg.pooled_projection_dim),
        "dual_blocks": dual,
        "single_blocks": single,
        "norm_out": {"linear": lin(d, 2 * d)},
        "proj_out": lin(d, cfg.out_channels),
    }
    if cfg.guidance_embeds:
        params["guidance_in"] = mlp_embed(cfg.time_embed_dim)
    return params


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers convention (flip_sin_to_cos=True,
    downscale_freq_shift=0): output = [cos | sin]. t: (B,) fp32, pre-scaled."""
    half = dim // 2
    freqs = torch.exp(
        -torch.log(torch.tensor(max_period, dtype=torch.float32, device=t.device))
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _mlp_embed(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["out"], F.silu(linear(p["in"], x)))


def _qk_norm_heads(x: torch.Tensor, scale: Params) -> torch.Tensor:
    return rms_norm(x, scale["scale"], eps=1e-6)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    # (S, 1, hd) tables broadcast over the head axis: BSHD in place
    return apply_rope_paired(x, cos[:, None, :], sin[:, None, :])


def _joint_attention(p, img, txt, cos, sin, cfg: FluxConfig, pad_mask):
    """MMDiT joint attention over [txt ++ img] tokens; returns (img_out, txt_out)."""
    b, s_img, d = img.shape
    s_txt = txt.shape[1]
    h, hd = cfg.num_attention_heads, cfg.attention_head_dim

    def heads(x):
        return x.reshape(b, -1, h, hd)

    lq_i, lk_i, lv_i = linear_multi([p["to_q"], p["to_k"], p["to_v"]], img)
    lq_t, lk_t, lv_t = linear_multi([p["add_q_proj"], p["add_k_proj"], p["add_v_proj"]], txt)
    q = torch.cat([_qk_norm_heads(heads(lq_t), p["norm_added_q"]),
                   _qk_norm_heads(heads(lq_i), p["norm_q"])], dim=1)
    k = torch.cat([_qk_norm_heads(heads(lk_t), p["norm_added_k"]),
                   _qk_norm_heads(heads(lk_i), p["norm_k"])], dim=1)
    v = torch.cat([heads(lv_t), heads(lv_i)], dim=1)
    out = dot_product_attention(_rope(q, cos, sin), _rope(k, cos, sin), v, pad_mask=pad_mask,
                                impl=cfg.attention_impl)
    out = out.reshape(b, s_txt + s_img, d)
    txt_out, img_out = out[:, :s_txt], out[:, s_txt:]
    return linear(p["to_out"], img_out), linear(p["to_add_out"], txt_out)


def _dual_block(p, mod, mod_ctx, img, txt, cos, sin, cfg: FluxConfig, pad_mask):
    sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = mod
    c_sh_msa, c_sc_msa, c_g_msa, c_sh_mlp, c_sc_mlp, c_g_mlp = mod_ctx

    fuse = cfg.fuse_mod_quant
    # W8A8: int8 rows from K2 (QuantRows), dispatched on the consuming
    # kernel's format; otherwise the modulated tensor
    img_mod = ln_modulate_quant(img, sh_msa, sc_msa, p["attn"]["to_q"], mode=fuse)
    txt_mod = ln_modulate_quant(txt, c_sh_msa, c_sc_msa, p["attn"]["add_q_proj"], mode=fuse)
    attn_img, attn_txt = _joint_attention(p["attn"], img_mod, txt_mod, cos, sin, cfg, pad_mask)

    img = img + g_msa[:, None, :] * attn_img
    img_mlp = ln_modulate_quant(img, sh_mlp, sc_mlp, p["ff"]["in"], mode=fuse)
    img = img + g_mlp[:, None, :] * linear_gelu(p["ff"]["out"], linear(p["ff"]["in"], img_mlp))

    txt = txt + c_g_msa[:, None, :] * attn_txt
    txt_mlp = ln_modulate_quant(txt, c_sh_mlp, c_sc_mlp, p["ff_context"]["in"], mode=fuse)
    txt = txt + c_g_mlp[:, None, :] * linear_gelu(
        p["ff_context"]["out"], linear(p["ff_context"]["in"], txt_mlp))
    return img, txt


def _single_block(p, mod, x, cos, sin, cfg: FluxConfig, pad_mask):
    b, s, d = x.shape
    h, hd = cfg.num_attention_heads, cfg.attention_head_dim
    shift, scale, gate = mod
    x_mod = ln_modulate_quant(x, shift, scale, p["attn"]["to_q"], mode=cfg.fuse_mod_quant)
    lq, lk, lv, mlp_h = linear_multi(
        [p["attn"]["to_q"], p["attn"]["to_k"], p["attn"]["to_v"], p["proj_mlp"]], x_mod)

    def heads(y):
        return y.reshape(b, s, h, hd)

    q = _rope(_qk_norm_heads(heads(lq), p["attn"]["norm_q"]), cos, sin)
    k = _rope(_qk_norm_heads(heads(lk), p["attn"]["norm_k"]), cos, sin)
    attn = dot_product_attention(q, k, heads(lv), pad_mask=pad_mask,
                                 impl=cfg.attention_impl).reshape(b, s, d)
    out = linear_concat(p["proj_out"], [attn, ("gelu", mlp_h)])
    return x + gate[:, None, :] * out


def apply(
    params: Params,
    cfg: FluxConfig,
    *,
    hidden_states: torch.Tensor,          # (B, S_img, in_channels) packed latents
    encoder_hidden_states: torch.Tensor,  # (B, S_txt, joint_attention_dim)
    pooled_projections: torch.Tensor,     # (B, pooled_projection_dim)
    timestep: torch.Tensor,               # (B,) in [0, 1]
    img_ids: torch.Tensor,                # (S_img, 3)
    txt_ids: Optional[torch.Tensor] = None,   # (S_txt, 3); zeros if None
    guidance: Optional[torch.Tensor] = None,  # (B,) guidance scale
    pad_mask: Optional[torch.Tensor] = None,  # (B, S_txt + S_img) keep-mask
    rope: Optional[tuple] = None,         # precomputed (cos, sin)
) -> torch.Tensor:
    """Velocity prediction, (B, S_img, out_channels)."""
    if cfg.attention_impl not in ("auto", "pallas_qk8", "pallas_int8"):
        raise NotImplementedError(f"attention_impl={cfg.attention_impl!r} is not ported; "
                                  "use 'auto', 'pallas_qk8' or 'pallas_int8'")
    if cfg.remat:
        raise NotImplementedError("remat (training) is not ported")
    s_txt = encoder_hidden_states.shape[1]
    compute_dtype = hidden_states.dtype

    img = linear(params["x_embedder"], hidden_states)
    txt = linear(params["context_embedder"], encoder_hidden_states.to(compute_dtype))

    t_emb = timestep_embedding(timestep.float() * 1000.0, cfg.time_embed_dim)
    temb = _mlp_embed(params["time_in"], t_emb.to(compute_dtype))
    if cfg.guidance_embeds:
        if guidance is None:
            raise ValueError("guidance-distilled model needs a guidance scale")
        g_emb = timestep_embedding(guidance.float() * 1000.0, cfg.time_embed_dim)
        temb = temb + _mlp_embed(params["guidance_in"], g_emb.to(compute_dtype))
    temb = temb + _mlp_embed(params["pooled_in"], pooled_projections.to(compute_dtype))

    if rope is not None:
        cos, sin = rope
    else:
        if txt_ids is None:
            txt_ids = torch.zeros(s_txt, 3, dtype=torch.float32, device=img_ids.device)
        cos, sin = flux_rope_freqs(torch.cat([txt_ids, img_ids], dim=0),
                                   cfg.axes_dims_rope, cfg.rope_theta)
    if cfg.rope_dtype == "bfloat16":
        cos, sin = cos.to(torch.bfloat16), sin.to(torch.bfloat16)

    # adaLN modulation vectors for all layers in one batched matmul each
    silu_t = F.silu(temb)
    dual_p, single_p = params["dual_blocks"], params["single_blocks"]
    dual_mod = adaln_stacked(dual_p["norm1"]["linear"], silu_t, 6)
    dual_mod_ctx = adaln_stacked(dual_p["norm1_context"]["linear"], silu_t, 6)
    single_mod = adaln_stacked(single_p["norm"]["linear"], silu_t, 3)
    dual_xs = {k: v for k, v in dual_p.items() if k not in ("norm1", "norm1_context")}
    single_xs = {k: v for k, v in single_p.items() if k != "norm"}

    for i in range(cfg.num_layers):
        img, txt = _dual_block(layer_slice(dual_xs, i), dual_mod[i], dual_mod_ctx[i],
                               img, txt, cos, sin, cfg, pad_mask)
    x = torch.cat([txt, img], dim=1)
    for i in range(cfg.num_single_layers):
        x = _single_block(layer_slice(single_xs, i), single_mod[i], x, cos, sin, cfg, pad_mask)
    x = x[:, s_txt:]

    scale, shift = torch.chunk(linear(params["norm_out"]["linear"], F.silu(temb)), 2, dim=-1)
    x = modulate(layer_norm(x, eps=1e-6), shift, scale)
    return linear(params["proj_out"], x)
