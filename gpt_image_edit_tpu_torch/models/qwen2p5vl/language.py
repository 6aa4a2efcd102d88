"""Qwen2.5 LM trunk (GQA + M-RoPE + SwiGLU): the prefill.

Counterpart of the prefill half of `gpt_image_edit_tpu.models.qwen2p5vl.
language`, over the same param tree (layers stacked on a leading axis).
Attention is causal with the prompt's pad mask, GQA 28/4 at head dim 128,
through K1. Prompts are left-padded, so the leading pad rows see no key:
K1 gives 0 there (the JAX XLA path on the CPU gives the mean of v); those
rows never reach a valid row, which masks them as keys. The KV-cache decode
(`prefill` with a cache, `decode_step`) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from gpt_image_edit_tpu_torch.models.common import (
    Params,
    layer_slice,
    linear,
    linear_init,
    linear_multi,
    normal_init,
    rms_weight_init,
)
from gpt_image_edit_tpu_torch.models.qwen2p5vl.config import TextConfig
from gpt_image_edit_tpu_torch.ops.attention import dot_product_attention
from gpt_image_edit_tpu_torch.ops.norms import rms_norm
from gpt_image_edit_tpu_torch.ops.rope import apply_rope_halves, mrope_freqs


def init(cfg: TextConfig, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    """A random param tree in the JAX layout, made on `device` in `dtype`
    with the JAX init's distributions."""
    d, hd, n = cfg.hidden_size, cfg.head_dim, cfg.num_layers
    kw = dict(device=device, dtype=dtype)

    def lin(i, o, layers=None, bias=True):
        return linear_init(generator, i, o, layers=layers, bias=bias, **kw)

    params: Params = {
        "embed_tokens": normal_init(generator, (cfg.vocab_size, d), 0.02, **kw),
        "layers": {
            "input_ln": rms_weight_init(d, layers=n, **kw),
            "attn": {
                "q": lin(d, cfg.num_heads * hd, n),
                "k": lin(d, cfg.num_kv_heads * hd, n),
                "v": lin(d, cfg.num_kv_heads * hd, n),
                "o": lin(cfg.num_heads * hd, d, n, bias=False),
            },
            "post_ln": rms_weight_init(d, layers=n, **kw),
            "mlp": {
                "gate": lin(d, cfg.intermediate_size, n, bias=False),
                "up": lin(d, cfg.intermediate_size, n, bias=False),
                "down": lin(cfg.intermediate_size, d, n, bias=False),
            },
        },
        "final_ln": rms_weight_init(d, **kw),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = lin(d, cfg.vocab_size, bias=False)
    return params


def _layer(p: Params, x, cos, sin, pad_mask, cfg: TextConfig):
    b, s, _ = x.shape
    h, hk, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["input_ln"]["scale"], cfg.rms_eps)
    q, k, v = linear_multi((p["attn"]["q"], p["attn"]["k"], p["attn"]["v"]), xn)
    # BSHD rope with (B, S, 1, D) tables
    q = apply_rope_halves(q.reshape(b, s, h, hd), cos[:, :, None], sin[:, :, None])
    k = apply_rope_halves(k.reshape(b, s, hk, hd), cos[:, :, None], sin[:, :, None])
    attn = dot_product_attention(q, k, v.reshape(b, s, hk, hd).contiguous(), causal=True,
                                 pad_mask=pad_mask)
    x = x + linear(p["attn"]["o"], attn.reshape(b, s, h * hd))
    xn = rms_norm(x, p["post_ln"]["scale"], cfg.rms_eps)
    gate, up = linear_multi((p["mlp"]["gate"], p["mlp"]["up"]), xn)
    return x + linear(p["mlp"]["down"], F.silu(gate) * up)


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Embedding rows; ids are clamped into the vocabulary, as the JAX
    package's gather clamps them."""
    table = params["embed_tokens"]
    return table[input_ids.clamp(0, table.shape[0] - 1)]


def trunk(params: Params, cfg: TextConfig, inputs_embeds: torch.Tensor,
          position_ids: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Final-norm hidden states (B, S, D) of the prefill."""
    cos, sin = mrope_freqs(position_ids, cfg.head_dim, cfg.mrope_section, cfg.rope_theta)
    # HF Qwen rotates in the activation dtype
    cos, sin = cos.to(inputs_embeds.dtype), sin.to(inputs_embeds.dtype)
    x = inputs_embeds
    for i in range(cfg.num_layers):
        x = _layer(layer_slice(params["layers"], i), x, cos, sin, pad_mask, cfg)
    return rms_norm(x, params["final_ln"]["scale"], cfg.rms_eps)
