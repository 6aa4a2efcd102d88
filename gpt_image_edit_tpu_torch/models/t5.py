"""T5 (v1.1 / XXL) text encoder.

Counterpart of `gpt_image_edit_tpu.models.t5`, over the same param tree:
the relative-position bias (computed once, shared by all layers), no
attention scaling (scale 1.0), RMSNorm without mean-centering, gated-GELU
MLP. The attention goes through K1 with the relative-position bias as its
additive fp32 bias, head dim 64 (the JAX package runs it on its XLA path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from gpt_image_edit_tpu_torch.models.common import (
    Params,
    gelu_tanh,
    layer_slice,
    linear,
    linear_init,
    normal_init,
    rms_weight_init,
)
from gpt_image_edit_tpu_torch.ops.attention import dot_product_attention
from gpt_image_edit_tpu_torch.ops.norms import rms_norm


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    rms_eps: float = 1e-6

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=512, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)


def init(cfg: T5Config, *, generator: torch.Generator, device, dtype=torch.float32) -> Params:
    """A random param tree in the JAX layout, made on `device` in `dtype`
    with the JAX init's distributions."""
    inner, n = cfg.num_heads * cfg.d_kv, cfg.num_layers
    kw = dict(device=device, dtype=dtype)

    def lin(i, o):
        return linear_init(generator, i, o, layers=n, bias=False, **kw)

    return {
        "embed": normal_init(generator, (cfg.vocab_size, cfg.d_model), 1.0, **kw),
        "rel_bias": normal_init(generator, (cfg.relative_attention_num_buckets, cfg.num_heads),
                                0.02, **kw),
        "layers": {
            "ln1": rms_weight_init(cfg.d_model, layers=n, **kw),
            "attn": {"q": lin(cfg.d_model, inner), "k": lin(cfg.d_model, inner),
                     "v": lin(cfg.d_model, inner), "o": lin(inner, cfg.d_model)},
            "ln2": rms_weight_init(cfg.d_model, layers=n, **kw),
            "mlp": {"wi0": lin(cfg.d_model, cfg.d_ff), "wi1": lin(cfg.d_model, cfg.d_ff),
                    "wo": lin(cfg.d_ff, cfg.d_model)},
        },
        "final_ln": rms_weight_init(cfg.d_model, **kw),
    }


def _relative_buckets(rel_pos: np.ndarray, num_buckets: int, max_distance: int) -> np.ndarray:
    """Bidirectional T5 relative-position bucketing (host-side)."""
    ret = np.zeros_like(rel_pos)
    n = num_buckets // 2
    ret += (rel_pos > 0).astype(np.int64) * n
    ap = np.abs(rel_pos)
    max_exact = n // 2
    large = max_exact + (np.log(np.maximum(ap, 1) / max_exact) / np.log(max_distance / max_exact)
                         * (n - max_exact)).astype(np.int64)
    ret += np.where(ap < max_exact, ap, np.minimum(large, n - 1))
    return ret


def relative_bias_table(cfg: T5Config, seq_len: int) -> np.ndarray:
    """(S, S) int bucket ids (memory - query)."""
    pos = np.arange(seq_len)
    return _relative_buckets(pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
                             cfg.relative_attention_max_distance)


def apply(params: Params, cfg: T5Config, input_ids: torch.Tensor,
          attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S) ids -> (B, S, d_model) final hidden states. Ids are clamped
    into the vocabulary, as the JAX package's gather clamps them."""
    b, s = input_ids.shape
    table = params["embed"]
    x = table[input_ids.clamp(0, table.shape[0] - 1)]
    buckets = torch.from_numpy(relative_bias_table(cfg, s)).to(x.device)
    bias = params["rel_bias"][buckets].permute(2, 0, 1)[None].float()  # (1, H, S, S)
    for i in range(cfg.num_layers):
        p = layer_slice(params["layers"], i)
        xn = rms_norm(x, p["ln1"]["scale"], cfg.rms_eps)
        q, k, v = (linear(p["attn"][n], xn).reshape(b, s, cfg.num_heads, cfg.d_kv)
                   for n in ("q", "k", "v"))
        attn = dot_product_attention(q, k, v, bias=bias, pad_mask=attention_mask, scale=1.0)
        x = x + linear(p["attn"]["o"], attn.reshape(b, s, -1))
        xn = rms_norm(x, p["ln2"]["scale"], cfg.rms_eps)
        x = x + linear(p["mlp"]["wo"], gelu_tanh(linear(p["mlp"]["wi0"], xn))
                       * linear(p["mlp"]["wi1"], xn))
    return rms_norm(x, params["final_ln"]["scale"], cfg.rms_eps)
