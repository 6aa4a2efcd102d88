"""CLIP text encoder (CLIP-L, FLUX's pooled conditioning).

Counterpart of `gpt_image_edit_tpu.models.clip`, over the same param tree:
pooled = the final-LN hidden state at the first EOS position. The causal
attention runs on K1, as T5's does (the JAX package sends both encoders to
its XLA path; no CLIP row has all its keys masked, so K1 computes the same
function). The SD3 encoders (their projection, activation and penultimate
layer, and the config fields for them) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from gpt_image_edit_tpu_torch.models.common import (
    Params,
    layer_norm_init,
    layer_slice,
    linear,
    linear_init,
    normal_init,
)
from gpt_image_edit_tpu_torch.ops.attention import dot_product_attention
from gpt_image_edit_tpu_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    eos_token_id: int = 49407
    ln_eps: float = 1e-5

    @classmethod
    def tiny(cls) -> "ClipTextConfig":
        return cls(vocab_size=512, hidden_size=32, num_layers=2, num_heads=2,
                   intermediate_size=64, max_position_embeddings=16, eos_token_id=511)


def init(cfg: ClipTextConfig, *, generator: torch.Generator, device,
         dtype=torch.float32) -> Params:
    """A random param tree in the JAX layout, made on `device` in `dtype`
    with the JAX init's distributions."""
    d, n = cfg.hidden_size, cfg.num_layers
    kw = dict(device=device, dtype=dtype)

    def lin(i, o):
        return linear_init(generator, i, o, layers=n, **kw)

    return {
        "token_embed": normal_init(generator, (cfg.vocab_size, d), 0.02, **kw),
        "pos_embed": normal_init(generator, (cfg.max_position_embeddings, d), 0.02, **kw),
        "layers": {
            "ln1": layer_norm_init(d, layers=n, **kw),
            "attn": {name: lin(d, d) for name in ("q", "k", "v", "o")},
            "ln2": layer_norm_init(d, layers=n, **kw),
            "mlp": {"fc1": lin(d, cfg.intermediate_size), "fc2": lin(cfg.intermediate_size, d)},
        },
        "final_ln": layer_norm_init(d, **kw),
    }


def _quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def apply(params: Params, cfg: ClipTextConfig,
          input_ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) -> (hidden (B, S, D), pooled (B, D)). Ids are clamped into the
    vocabulary for the embedding gather, as the JAX package's gather clamps
    them; the EOS position is found on the ids as given."""
    b, s = input_ids.shape
    h, hd = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    table = params["token_embed"]
    x = table[input_ids.clamp(0, table.shape[0] - 1)] + params["pos_embed"][:s]
    for i in range(cfg.num_layers):
        p = layer_slice(params["layers"], i)
        xn = layer_norm(x, p["ln1"]["scale"], p["ln1"]["bias"], cfg.ln_eps)
        q, k, v = (linear(p["attn"][n], xn).reshape(b, s, h, hd) for n in ("q", "k", "v"))
        attn = dot_product_attention(q, k, v, causal=True)
        x = x + linear(p["attn"]["o"], attn.reshape(b, s, -1))
        xn = layer_norm(x, p["ln2"]["scale"], p["ln2"]["bias"], cfg.ln_eps)
        x = x + linear(p["mlp"]["fc2"], _quick_gelu(linear(p["mlp"]["fc1"], xn)))
    final = layer_norm(x, params["final_ln"]["scale"], params["final_ln"]["bias"], cfg.ln_eps)
    eos_pos = torch.argmax((input_ids == cfg.eos_token_id).int(), dim=-1)
    return final, final[torch.arange(b, device=final.device), eos_pos]
