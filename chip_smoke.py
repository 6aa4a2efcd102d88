#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (gpt_image_edit_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and the CUDA toolkit.
Phases, each of which ends the run with a non-zero exit if it fails:

1. Device: the card's name and power limit, the versions, and the build of
   every kernel of the path from the sources in this checkout (one nvcc per
   source, all started together), with each kernel's registers and spills.
2. Kernel vs plain, on the card, each kernel against its plain PyTorch
   version on the shapes the main path gives it, with timings of the
   kernel, the plain version, the bound and the nearest PyTorch call:
   - K1 flash attention, bf16: the FLUX shape with a text pad mask, a
     ragged length, segments, causal with Sq != Skv, GQA, a row with every
     key masked, an additive bias, a left-padded causal GQA prefill, a
     16,896-token sequence;
   - K2 fused ln + modulate + int8 rows: the image, text, single-block and
     ragged sites of FLUX at 1024^2 and a batch of 2 (codes within 1 LSB,
     under 1e-3 of them off by one, scales within 1 bf16 ulp);
   - K3 int8-q k^T flash attention: the FLUX shape with a text pad mask, a
     ragged length, GQA 28/4, a row with every key masked (relative L2 to
     the plain version, and K1 on the same inputs several times farther);
   - K4 int8 q k^T + int8 p v flash attention: the FLUX shape with a text
     pad mask, the runtime's 1024^2 joint length 8,832 (a ragged last
     512-key group), segments, causal GQA 28/4 with a left pad, a row with
     every key masked (relative L2 to the plain version at 512-key groups;
     K3 and the plain version at 64-key groups several times farther);
   - the int8 products W8A8 runs on torch._int_mm, exact, beside bf16
     products of the same shapes.
3. Small references: a two-block model through KontextPipeline on the card
   against the same weights through the plain CPU path, in bf16 and in
   W8A8 (w8a8, w8a8-qk8, w8a8-attn), each nearer its own mode's output than
   the other mode's, with its mode's kernel launches; then one forward per
   W8A8 mode at the card's precision: w8a8-attn nearer its own mode's CPU
   output than w8a8's and w8a8-qk8's, and each of its attention calls
   nearer K4's plain version than K1's and K3's on the same inputs.
4. Edits: the full-width FLUX.1-Kontext (19 dual + 38 single blocks, 3072
   wide) and the full VAE, random weights from seed 0, answer edit requests
   through KontextPipeline.__call__ at the serving config (bf16 rope
   tables): two in bf16; then the same FLUX, quantized W8A8 on the card
   (the VAE stays bf16), one under w8a8 and two under w8a8-qk8. Each
   kernel's launch counter is set to 0 before each edit and must show the
   launches of its path: per MMDiT forward 57 K1 (bf16, w8a8), 114 K2
   (w8a8, w8a8-qk8) and 57 K3 (w8a8-qk8).
5. Profiles: one 1024^2 MMDiT forward under torch.profiler per mode,
   device time by kind (attention kernel, K2, int8 GEMMs, bf16 GEMMs, the
   rest).
6. The runtime: with the earlier models freed,
   UnivaRuntime(synthetic_full=True, quantize="w8a8-attn") (Qwen2.5-VL-7B,
   T5-XXL, CLIP-L, W8A8 FLUX, the VAE; seeded random weights) answers two
   requests through `edit`: a 1024^2 image, 28 steps, and a 1248x832 image
   with true CFG 4.0, 6 steps (cut from 28 to keep the run short). Per
   request: wall and stage times, peak memory, the joint length, uint8
   output of the requested size, finite latents, and the launches: per
   MMDiT forward 57 K4 and 114 K2, no K3, and K1 for the ViT, the LM
   prefill, T5 and CLIP. Then a profile of one w8a8-attn forward.

It prints one {"kernels": [...]} line, then, as the last line,
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch
from PIL import Image

from gpt_image_edit_tpu_torch.models import common
from gpt_image_edit_tpu_torch.models.common import cast_floating
from gpt_image_edit_tpu_torch.models.flux import FluxConfig, apply_flux
from gpt_image_edit_tpu_torch.models.vae import VaeConfig
from gpt_image_edit_tpu_torch.ops.kernels import build as kernel_build
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention as fa
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention_int8 as k4
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention_qk8 as qk8
from gpt_image_edit_tpu_torch.ops.kernels import fused_quant as fq
from gpt_image_edit_tpu_torch.ops.packing import latent_image_ids
from gpt_image_edit_tpu_torch.pipeline import KontextPipeline, postprocess_to_uint8
from gpt_image_edit_tpu_torch.serve.runtime import UnivaRuntime
from gpt_image_edit_tpu_torch.utils.quantize import params_nbytes, quantize_params, w8a8_layout
from gpt_image_edit_tpu_torch.utils.synthetic import synthetic_flux, synthetic_vae

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
ATTN_ATOL = 1e-2           # bf16 output; the kernel rounds p to bf16 before p @ v
K2_MAX_OFF_SHARE = 1e-3    # share of K2 codes 1 LSB off the plain version's
QK8_REL_L2 = 4e-3          # K3 vs its plain version (same int8 q, k), relative L2: both
                           # round p and out to bf16 (~2.4e-3 apart); K1 is ~1e-2 away
QK8_MIN_RATIO = 3.0        # K1 (bf16 q k^T) at least this many times farther from K3
INT8_REL_L2 = 5e-4         # K4 vs its plain version (same int8 codes), relative L2: the
                           # kernel's ex2.approx moves a few p8 codes by 1 (~6e-5 apart)
INT8_MIN_RATIO = 3.0       # K3 and the plain version at 64-key groups this many times farther
# 2^x on the special-function units: 16 results per SM per clock on sm_90
# (CUDA C++ Programming Guide, arithmetic instruction throughput), 132 SMs,
# 1.98 GHz boost clock
SFU_EXP2_RATE = 132 * 16 * 1.98e9
SMALL_OUTLIER = 32.0       # small model: input row 0 of each quantized kernel scaled up
SMALL_REL_L2 = 5e-2        # small model: card vs its own mode's fp32 CPU path, relative L2
SMALL_MIN_RATIO = 3.0      # ... and the other mode's CPU path this many times farther
SMALL_ATTN_RATIO = 1.1     # w8a8-attn vs the other W8A8 modes at matched precision: measured
                           # 1.14-1.26 over six variants of the small model (outlier 1/4/32,
                           # 128/512 image tokens), where K4's own effect is ~1e-2 of the output
INT8_GEMM_MARKS = ("gemm_s8", "s8s8", "imma")  # cuBLASLt's int8 tensor-core kernel names
KERNELS = ("flash_attention_fwd", "fused_quant", "flash_attention_qk8", "flash_attention_int8")
COUNTERS = {"flash_attention_fwd": fa.flash_attention,
            "fused_quant": fq.ln_modulate_quant_rows,
            "flash_attention_qk8": qk8.flash_attention_qk8,
            "flash_attention_int8": k4.flash_attention_int8}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int = 20) -> float:
    """Device time per launch of the kernels whose name contains `kernel`,
    from torch.profiler over `iters` calls of fn: a short kernel's own time,
    which CUDA events around the calls would hide behind the host's
    per-call overhead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.self_device_time_total for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key]
    check(len(us) > 0, f"the profiler saw no {kernel}")
    return sum(us) / iters / 1e3


def randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


# --------------------------------------------------------------------------
# phase 2: kernel vs plain
# --------------------------------------------------------------------------

def attention_case(name, gen, b, sq, skv, hq, hkv, d, rtol=0.0, **masks):
    """K1 against its plain version; |out - ref| <= ATTN_ATOL + rtol |ref|."""
    q = randn(gen, b, sq, hq, d)
    k = randn(gen, b, skv, hkv, d)
    v = randn(gen, b, skv, hkv, d)
    out = fa.flash_attention(q, k, v, **masks)
    ref = fa.flash_attention_reference(q, k, v, **masks)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"attention case {name}: non-finite output")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - rtol * ref.float().abs()).max().item()
    print(f"[attn] {name}: B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} d={d} "
          f"max_abs_err={err:.3e} (atol {ATTN_ATOL}{f' + {rtol:.4g} |ref|' if rtol else ''})",
          flush=True)
    check(excess <= ATTN_ATOL, f"attention case {name}: max abs err {err} over the tolerance")
    return q, k, v, out, ref, err


def attention_phase():
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (a) FLUX joint attention at 1024^2: 512 text + 4096 target + 4096 ref tokens,
    # 128 of the 512 text keys padded
    s_txt, s = 512, 512 + 8192
    pad = torch.ones(1, s, dtype=torch.bool, device="cuda")
    pad[:, 384:s_txt] = False
    q, k, v, _, _, err_a = attention_case("a_flux_pad", gen, 1, s, s, 24, 24, 128, pad_mask=pad)
    kernel_ms = time_ms(lambda: fa.flash_attention(q, k, v, pad_mask=pad), iters=20)
    nomask_ms = time_ms(lambda: fa.flash_attention(q, k, v), iters=20)
    plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v, pad_mask=pad), iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_mask = pad[:, None, None, :]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=sdpa_mask), iters=20)
    kept = int(pad.sum())
    flops = 4 * 1 * 24 * s * kept * 128
    nbytes = 4 * q.numel() * q.element_size() + pad.numel()
    bound_s = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_HBM_BYTES else "bytes"
    print(f"[attn] a_flux_pad timing: kernel {kernel_ms:.4f} ms "
          f"({flops / kernel_ms / 1e9:.1f} TFLOP/s; {nomask_ms:.4f} ms without a mask), "
          f"plain {plain_ms:.3f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_s * 1e3:.4f} ms ({bound_by})", flush=True)
    del q, k, v, qt, kt, vt

    # (b) ragged: the 832x1248 bucket with 640 text tokens, 8,752 = 136.75 tiles
    s = 640 + 2 * 4056
    pad = torch.ones(1, s, dtype=torch.bool, device="cuda")
    pad[:, 500:640] = False
    attention_case("b_ragged_8752", gen, 1, s, s, 24, 24, 128, pad_mask=pad)
    # (c) segments (windowed vision attention), d = 80, ragged windows
    seg = torch.repeat_interleave(torch.arange(13, device="cuda"), 79)[None].repeat(2, 1).int()
    attention_case("c_segments", gen, 2, seg.shape[1], seg.shape[1], 16, 16, 80,
                   q_segment_ids=seg, kv_segment_ids=seg)
    # (d) end-aligned causal with Sq != Skv (a chunked prefill against a cache)
    attention_case("d_causal_sq_ne_skv", gen, 1, 300, 1000, 8, 8, 128, causal=True)
    # (e) GQA 28 q heads over 4 kv heads, causal with a pad mask (LM prefill)
    pad = torch.ones(2, 777, dtype=torch.bool, device="cuda")
    pad[1, 600:] = False
    attention_case("e_gqa_28_4", gen, 2, 777, 777, 28, 4, 128, causal=True, pad_mask=pad)
    # (f) rows whose keys are all masked give 0
    qs = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    qs[:, 10:20] = 5  # no key carries segment 5
    _, _, _, out, _, _ = attention_case("f_fully_masked_rows", gen, 1, 256, 256, 4, 4, 64,
                                        q_segment_ids=qs,
                                        kv_segment_ids=torch.zeros_like(qs))
    check(bool((out[:, 10:20] == 0).all()), "fully masked rows are not 0")
    # (g) additive bias broadcast over batch, fp16, explicit scale
    bias = torch.randn(1, 8, 333, 333, generator=gen, device="cuda")
    q = randn(gen, 2, 333, 8, 64, dtype=torch.float16)
    out = fa.flash_attention(q, q, q, bias=bias, scale=0.1)
    ref = fa.flash_attention_reference(q, q, q, bias=bias, scale=0.1)
    err_g = (out.float() - ref.float()).abs().max().item()
    print(f"[attn] g_bias_fp16_scale: max_abs_err={err_g:.3e} (atol {ATTN_ATOL})", flush=True)
    check(err_g <= ATTN_ATOL, f"attention case g: max abs err {err_g}")
    del q, out, ref, bias
    # (i) the serving LM prefill layout: prompts left-padded to a multiple
    # of 128, causal + pad, GQA 28/4 at d = 128; the leading pad rows of the
    # padded prompt see no key and must be 0. The first valid rows see a
    # handful of keys, so their outputs keep |v|-sized values (up to ~4,
    # where one bf16 ulp is 1.6e-2): the bar adds one bf16 ulp of |ref|
    pad = torch.ones(2, 768, dtype=torch.bool, device="cuda")
    pad[1, :200] = False
    _, _, _, out, _, _ = attention_case("i_left_pad_causal_gqa", gen, 2, 768, 768, 28, 4, 128,
                                        rtol=2.0 ** -7, causal=True, pad_mask=pad)
    check(bool((out[1, :200] == 0).all()), "left-padded causal rows are not 0")
    # (h) the long-sequence regime the Pallas grid kernel covered (K/V over
    # 8 MB per head): 512 text + four 1024^2 images, S = 16,896
    s = 512 + 4 * 4096
    q, k, v, _, _, _ = attention_case("h_long_16896", gen, 1, s, s, 24, 24, 128)
    long_ms = time_ms(lambda: fa.flash_attention(q, k, v), iters=5)
    long_plain_ms = time_ms(lambda: fa.flash_attention_reference(q, k, v), iters=2, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    long_sdpa_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt),
                           iters=5)
    flops = 4 * 24 * s * s * 128
    print(f"[attn] h_long_16896 timing: kernel {long_ms:.4f} ms ({flops / long_ms / 1e9:.1f} "
          f"TFLOP/s), plain {long_plain_ms:.3f} ms, sdpa {long_sdpa_ms:.4f} ms, "
          f"bound {flops / PEAK_BF16_FLOPS * 1e3:.4f} ms (operations)", flush=True)
    del q, k, v, qt, kt, vt
    return dict(max_abs_err=err_a, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by)


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each (positive) value: 2^(floor(log2 v) - 7)."""
    return torch.exp2(torch.floor(torch.log2(v)) - 7)


def fused_quant_case(name, gen, b, s, d):
    """K2 against its plain version on one prologue site: codes within 1
    LSB, few of them off by one, scales within 1 bf16 ulp of the row max."""
    x = randn(gen, b, s, d, dtype=torch.float32)
    x[:, :, :: max(1, d // 8)] *= 8.0  # a few large channels, as activations have
    x = x.to(torch.bfloat16)
    shift, scale = randn(gen, b, d) * 0.5, randn(gen, b, d) * 0.5  # each batch row its own
    q, sx = fq.ln_modulate_quant_rows(x, shift, scale)
    q_ref, sx_ref = fq.ln_modulate_quant_rows_reference(x, shift, scale)
    torch.cuda.synchronize()
    off = (q.int() - q_ref.int()).abs()
    share = (off > 0).float().mean().item()
    ulps = ((sx - sx_ref).abs() * 127 / bf16_ulp(sx_ref * 127)).max().item()
    print(f"[k2] {name}: B={b} S={s} D={d} codes max |diff| {off.max().item()} LSB, "
          f"{share:.3e} of them off (limit {K2_MAX_OFF_SHARE}), scales within {ulps:.3f} "
          f"bf16 ulp of the row max", flush=True)
    check(off.max().item() <= 1, f"K2 case {name}: a code is more than 1 LSB off")
    check(share < K2_MAX_OFF_SHARE, f"K2 case {name}: {share} of the codes are off")
    check(ulps <= 1.0, f"K2 case {name}: a scale is {ulps} bf16 ulps off")
    return x, shift, scale, off.max().item(), share


def fused_quant_phase():
    gen = torch.Generator(device="cuda").manual_seed(1)
    d = 3072
    errs, shares = [], []
    for name, b, s in (("image_site", 1, 8192), ("text_site", 1, 512), ("single_site", 1, 8704),
                       ("ragged_8752", 1, 8752), ("batch_2", 2, 8192)):
        out = fused_quant_case(name, gen, b, s, d)
        errs.append(out[3])
        shares.append(out[4])
        if name == "single_site":
            x, shift, scale = out[:3]
    kernel_ms = device_ms(lambda: fq.ln_modulate_quant_rows(x, shift, scale),
                          "ln_modulate_quant_kernel", iters=50)
    wrapper_ms = time_ms(lambda: fq.ln_modulate_quant_rows(x, shift, scale), iters=50)
    plain_ms = time_ms(lambda: fq.ln_modulate_quant_rows_reference(x, shift, scale), iters=10)
    b, s, _ = x.shape
    nbytes = x.numel() * 2 + x.numel() + b * s * 4 + 2 * b * d * 2  # bf16 in; int8 + fp32 out
    bound_ms = nbytes / PEAK_HBM_BYTES * 1e3
    print(f"[k2] single_site timing: kernel {kernel_ms:.4f} ms on the device "
          f"({nbytes / kernel_ms / 1e6:.0f} GB/s; {wrapper_ms:.4f} ms per wrapper call with the "
          f"host's overhead), plain chain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes); "
          f"no single PyTorch call computes it", flush=True)
    return dict(max_abs_err=max(errs), off_share=max(shares), ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=None)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def qk8_case(name, gen, b, s, hq, hkv, d, pad_mask=None):
    """K3 against its plain version: relative L2 within QK8_REL_L2, and K1
    (the same attention with bf16 q k^T) at least QK8_MIN_RATIO times
    farther, so a kernel that does not quantize q and k fails."""
    q = randn(gen, b, s, hq, d)
    k = randn(gen, b, s, hkv, d)
    v = randn(gen, b, s, hkv, d)
    out = qk8.flash_attention_qk8(q, k, v, pad_mask=pad_mask)
    ref = qk8.flash_attention_qk8_reference(q, k, v, pad_mask=pad_mask)
    k1 = fa.flash_attention(q, k, v, pad_mask=pad_mask)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"qk8 case {name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    rel, rel_k1 = rel_l2(out, ref), rel_l2(out, k1)
    print(f"[k3] {name}: B={b} S={s} Hq={hq} Hkv={hkv} d={d} rel-L2 {rel:.3e} (limit "
          f"{QK8_REL_L2}), max_abs_err={err:.3e}; against K1 on the same bf16 inputs rel-L2 "
          f"{rel_k1:.3e}, {rel_k1 / max(rel, 1e-30):.1f}x (at least {QK8_MIN_RATIO}x: the "
          f"int8 q k^T error)", flush=True)
    check(rel <= QK8_REL_L2, f"qk8 case {name}: rel-L2 {rel} > {QK8_REL_L2}")
    check(rel_k1 >= QK8_MIN_RATIO * rel,
          f"qk8 case {name}: K3 is as near K1 ({rel_k1}) as its plain version ({rel})")
    return q, k, v, out, err, rel


def qk8_phase():
    gen = torch.Generator(device="cuda").manual_seed(2)
    s_txt, s = 512, 512 + 8192
    pad = torch.ones(1, s, dtype=torch.bool, device="cuda")
    pad[:, 384:s_txt] = False
    q, k, v, _, err, rel = qk8_case("a_flux_pad", gen, 1, s, 24, 24, 128, pad)
    kernel_ms = device_ms(lambda: qk8.flash_attention_qk8(q, k, v, pad_mask=pad),
                          "flash_qk8_kernel", iters=10)
    wrapper_ms = time_ms(lambda: qk8.flash_attention_qk8(q, k, v, pad_mask=pad), iters=20)
    quant_ms = time_ms(lambda: (qk8.quantize_heads(q), qk8.quantize_heads(k)), iters=20)
    plain_ms = time_ms(lambda: qk8.flash_attention_qk8_reference(q, k, v, pad_mask=pad),
                       iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=pad[:, None, None, :]), iters=20)
    kept = int(pad.sum())
    ops = 2 * 24 * s * kept * 128  # q k^T (int8) and as many p v (bf16)
    # the kernel's inputs and output: int8 q, k and their fp32 row scales,
    # bf16 v, the pad row; bf16 out
    nbytes = 2 * q.numel() + 2 * 24 * s * 4 + 2 * v.numel() * 2 + pad.numel()
    ops_s = ops / PEAK_INT8_OPS + ops / PEAK_BF16_FLOPS
    bound_ms = max(ops_s, nbytes / PEAK_HBM_BYTES) * 1e3
    bound_by = "operations" if ops_s >= nbytes / PEAK_HBM_BYTES else "bytes"
    print(f"[k3] a_flux_pad timing: kernel {kernel_ms:.4f} ms on the device "
          f"({2 * ops / kernel_ms / 1e9:.1f} TOP/s); wrapper {wrapper_ms:.4f} ms with the q/k "
          f"quantization ({quant_ms:.4f} ms alone), plain {plain_ms:.3f} ms, sdpa on the bf16 inputs "
          f"{library_ms:.4f} ms (nearest library call; no PyTorch call does int8 q k^T), "
          f"bound {bound_ms:.4f} ms ({bound_by})", flush=True)
    del q, k, v, qt, kt, vt
    s = 640 + 2 * 4056
    pad = torch.ones(1, s, dtype=torch.bool, device="cuda")
    pad[:, 500:640] = False
    qk8_case("b_ragged_8752", gen, 1, s, 24, 24, 128, pad)
    qk8_case("c_gqa_28_4", gen, 2, 1024, 28, 4, 128)
    pad = torch.ones(2, 256, dtype=torch.bool, device="cuda")
    pad[1] = False
    _, _, _, out, _, _ = qk8_case("d_fully_masked_rows", gen, 2, 256, 4, 4, 128, pad)
    check(bool((out[1] == 0).all()), "qk8: rows with every key masked are not 0")
    return dict(max_abs_err=err, rel_l2=rel, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def int8_case(name, gen, b, sq, skv, hq, hkv, d, **masks):
    """K4 against its plain version (512-key groups): relative L2 within
    INT8_REL_L2, and two other functions on the same inputs at least
    INT8_MIN_RATIO times farther: the plain version at 64-key groups (a
    kernel that requantizes p per tile) and, where it applies (a pad mask
    only), K3 (a kernel that skips the int8 p v)."""
    q = randn(gen, b, sq, hq, d)
    k = randn(gen, b, skv, hkv, d)
    v = randn(gen, b, skv, hkv, d)
    out = k4.flash_attention_int8(q, k, v, **masks)
    ref = k4.flash_attention_int8_reference(q, k, v, **masks)
    others = {"plain at 64-key groups": k4.flash_attention_int8_reference(q, k, v, block_kv=64,
                                                                          **masks)}
    if set(masks) <= {"pad_mask"} and sq == skv:
        others["K3"] = qk8.flash_attention_qk8(q, k, v, pad_mask=masks.get("pad_mask"))
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"int8 case {name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    rel = rel_l2(out, ref)
    rel_o = {n: rel_l2(out, o) for n, o in others.items()}
    print(f"[k4] {name}: B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} d={d} rel-L2 {rel:.3e} (limit "
          f"{INT8_REL_L2}), max_abs_err={err:.3e}; against "
          + ", ".join(f"{n} {r:.3e} ({r / max(rel, 1e-30):.1f}x)" for n, r in rel_o.items())
          + f" (each at least {INT8_MIN_RATIO}x)", flush=True)
    check(rel <= INT8_REL_L2, f"int8 case {name}: rel-L2 {rel} > {INT8_REL_L2}")
    for n, r in rel_o.items():
        check(r >= INT8_MIN_RATIO * rel, f"int8 case {name}: K4 is as near {n} ({r}) as its plain "
                                         f"version ({rel})")
    return q, k, v, out, err, rel


def int8_attention_phase():
    gen = torch.Generator(device="cuda").manual_seed(6)
    # (a) the FLUX joint attention at 1024^2 with a 512-row text pad mask
    s_txt, s = 512, 512 + 8192
    pad = torch.ones(1, s, dtype=torch.bool, device="cuda")
    pad[:, 384:s_txt] = False
    q, k, v, _, err, rel = int8_case("a_flux_pad_8704", gen, 1, s, s, 24, 24, 128, pad_mask=pad)
    kernel_ms = device_ms(lambda: k4.flash_attention_int8(q, k, v, pad_mask=pad),
                          "flash_int8_kernel", iters=10)
    wrapper_ms = time_ms(lambda: k4.flash_attention_int8(q, k, v, pad_mask=pad), iters=20)
    quant_ms = time_ms(lambda: (qk8.quantize_heads(q), qk8.quantize_heads(k),
                                k4.quantize_v_columns(v)), iters=20)
    plain_ms = time_ms(lambda: k4.flash_attention_int8_reference(q, k, v, pad_mask=pad),
                       iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=pad[:, None, None, :]), iters=20)
    kept = int(pad.sum())
    ops = 4 * 24 * s * kept * 128   # q k^T and p v, both int8
    n_exp2 = 24 * s * kept          # one 2^x per kept score
    # the kernel's inputs and output: int8 q, k, v and their fp32 scales, the
    # pad row; bf16 out
    nbytes = 3 * q.numel() + 2 * 24 * s * 4 + 24 * 128 * 4 + pad.numel() + 2 * q.numel()
    times = {"operations": max(ops / PEAK_INT8_OPS, n_exp2 / SFU_EXP2_RATE),
             "bytes": nbytes / PEAK_HBM_BYTES}
    bound_by = max(times, key=times.get)
    bound_ms = times[bound_by] * 1e3
    print(f"[k4] a_flux_pad_8704 timing: kernel {kernel_ms:.4f} ms on the device; wrapper "
          f"{wrapper_ms:.4f} ms with the q/k/v quantization ({quant_ms:.4f} ms alone), plain "
          f"{plain_ms:.3f} ms, sdpa on the bf16 inputs {library_ms:.4f} ms (nearest library call; "
          f"no PyTorch call does int8 attention), bound {bound_ms:.4f} ms ({bound_by}: int8 "
          f"{ops / PEAK_INT8_OPS * 1e3:.4f} ms, exp2 {n_exp2 / SFU_EXP2_RATE * 1e3:.4f} ms, bytes "
          f"{times['bytes'] * 1e3:.4f} ms)", flush=True)
    del q, k, v, qt, kt, vt
    # (b) the runtime's 1024^2 joint length: 384 VLM rows + 256 T5 rows +
    # 8,192 image tokens = 8,832, a ragged last 512-key group
    s = 640 + 8192
    pad = torch.ones(1, s, dtype=torch.bool, device="cuda")
    pad[:, :100] = False  # the VLM rows' left padding
    int8_case("b_runtime_8832", gen, 1, s, s, 24, 24, 128, pad_mask=pad)
    # (c) segments that straddle the 64- and 512-key group edges
    seg = (torch.arange(2048, device="cuda") // 300)[None].repeat(2, 1).int()
    int8_case("c_segments", gen, 2, 2048, 2048, 8, 8, 128, q_segment_ids=seg, kv_segment_ids=seg)
    # (d) causal GQA 28/4 with a left pad (the LM prefill layout), Sq == Skv;
    # the leading rows of the padded prompt see no key and must be 0
    pad = torch.ones(2, 1024, dtype=torch.bool, device="cuda")
    pad[1, :300] = False
    _, _, _, out, _, _ = int8_case("d_causal_gqa_28_4_left_pad", gen, 2, 1024, 1024, 28, 4, 128,
                                   causal=True, pad_mask=pad)
    check(bool((out[1, :300] == 0).all()), "int8: left-padded causal rows are not 0")
    # (e) a batch row whose keys are all masked gives 0
    pad = torch.ones(2, 1024, dtype=torch.bool, device="cuda")
    pad[1] = False
    _, _, _, out, _, _ = int8_case("e_fully_masked_rows", gen, 2, 1024, 1024, 4, 4, 128,
                                   pad_mask=pad)
    check(bool((out[1] == 0).all()), "int8: rows with every key masked are not 0")
    return dict(max_abs_err=err, rel_l2=rel, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# --------------------------------------------------------------------------
# phase 3: a small model on the card against the plain CPU path
# --------------------------------------------------------------------------

def int8_gemm_phase():
    """torch._int_mm, as models.common calls it, at the FLUX shapes on codes
    in `w8a8_layout` (the layout utils.quantize stores), exact, beside a
    bf16 product of the same shape. Then the zero-row padding at a shape
    cuBLASLt refuses unpadded (8 rows at K = 64)."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)

    for m, k, n in ((8704, 3072, 3072), (8192, 3072, 12288), (8704, 12288, 3072),
                    (1, 3072, 18432)):
        a, b = codes(m, k), w8a8_layout(codes(k, n))
        check(torch.equal(common._int_mm(a, b).long(), (a.double() @ b.double()).long()),
              f"int8 product {m}x{k}x{n} is not exact")
        int8_ms = time_ms(lambda: common._int_mm(a, b), iters=10)
        x = randn(gen, m, k)
        w = randn(gen, k, n)
        bf16_ms = time_ms(lambda: x @ w, iters=10)
        print(f"[int8 gemm] {m}x{k}x{n}: int8 {int8_ms:.4f} ms "
              f"({2 * m * k * n / int8_ms / 1e9:.1f} TOP/s); bf16 matmul {bf16_ms:.4f} ms",
              flush=True)
    a, b = codes(8, 64), w8a8_layout(codes(64, 256))
    check(torch.equal(common._int_mm(a, b).long(), (a.double() @ b.double()).long()),
          "padded 8-row int8 product is not exact")


SMALL_MODES = ("bf16", "w8a8", "w8a8-qk8", "w8a8-attn")
SMALL_IMPL = {"w8a8": "auto", "w8a8-qk8": "pallas_qk8", "w8a8-attn": "pallas_int8"}


def small_model(mode):
    """The two-block model of the small references, fp32 on the CPU. Input
    row 0 of every kernel that W8A8 quantizes is SMALL_OUTLIER times
    larger, as outlier channels make it in trained models: its codes
    quantize the other rows coarsely, so the W8A8 modes' own error stands
    well above bf16's rounding and each mode's output is told apart from
    the others'. The W8A8 modes quantize these weights once, here."""
    fcfg = FluxConfig(in_channels=16, out_channels=16, num_layers=2, num_single_layers=2,
                      attention_head_dim=128, num_attention_heads=2, joint_attention_dim=64,
                      pooled_projection_dim=32)
    vcfg = VaeConfig.tiny()
    fp = synthetic_flux(fcfg, seed=3, device="cpu", dtype=torch.float32)
    vp = synthetic_vae(vcfg, seed=4, device="cpu", dtype=torch.float32)
    min_size = 1 << 16  # every kernel but the embedders, whose 16- to 64-wide
    # inputs serving (min_size 2^20) never quantizes

    def outliers(tree):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                outliers(leaf)
            elif key == "kernel" and leaf.dim() >= 2 and leaf.numel() >= min_size:
                leaf[..., 0, :] *= SMALL_OUTLIER

    outliers(fp)
    if mode != "bf16":
        quantize_params(fp, mode="w8a8", min_size=min_size)
        fcfg = dataclasses.replace(fcfg, fuse_mod_quant="on", attention_impl=SMALL_IMPL[mode])
    return fp, fcfg, vp, vcfg


def to_bf16(tree, device):
    """A CPU param tree on `device`: quantized kernels (codes and fp32
    scales) as they are, every other floating leaf in bf16."""
    if isinstance(tree, dict):
        if "q_w8a8" in tree:
            return {k: v.to(device) for k, v in tree.items()}
        return {k: to_bf16(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.bfloat16 if tree.is_floating_point() else None)


def small_reference_phase():
    """The small model through KontextPipeline, 4 steps, in each mode: bf16
    on the card against the fp32 CPU plain path with the same weights (and
    the same int8 codes), compared on the denoising update (final latent
    minus the initial noise). The card must lie within SMALL_REL_L2 of its
    own mode's reference and SMALL_MIN_RATIO times farther from the other
    mode's (w8a8's for bf16, bf16's for the W8A8 modes), and its launch
    counters must show its mode's kernels.

    The W8A8 modes differ from each other only in their attention, by
    less than bf16 moves their activation codes from the fp32 path, so
    `attention_mode_reference` tells them apart."""
    rng = np.random.default_rng(5)
    req = dict(
        prompt_embeds=torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(np.float32)),
        pooled_prompt_embeds=torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32)),
        image=torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)),
        latents=torch.from_numpy(rng.standard_normal((1, 64, 16)).astype(np.float32)),
        txt_pad_mask=torch.tensor([[1] * 6 + [0] * 2], dtype=torch.bool),
    )

    def on(device):
        return {n: (x.to(device, torch.bfloat16) if x.is_floating_point() else x.to(device))
                for n, x in req.items()}

    kw = dict(height=64, width=64, num_inference_steps=4, output_type="latent")
    refs, models = {}, {}
    for mode in SMALL_MODES:
        models[mode] = small_model(mode)
        fp, fcfg, vp, vcfg = models[mode]
        refs[mode] = KontextPipeline(fp, fcfg, vp, vcfg, device="cpu")(**req, **kw) - req["latents"]
    other = {"bf16": "w8a8", "w8a8": "bf16", "w8a8-qk8": "bf16", "w8a8-attn": "bf16"}
    n_attn = kw["num_inference_steps"] * (2 + 2)           # attention per step: 2 + 2 blocks
    n_k2 = kw["num_inference_steps"] * (4 * 2 + 2)         # K2: 4 per dual, 1 per single
    wants = {"bf16": {"flash_attention_fwd": n_attn},
             "w8a8": {"flash_attention_fwd": n_attn, "fused_quant": n_k2},
             "w8a8-qk8": {"fused_quant": n_k2, "flash_attention_qk8": n_attn},
             "w8a8-attn": {"fused_quant": n_k2, "flash_attention_int8": n_attn}}
    for mode in SMALL_MODES:
        fp, fcfg, vp, vcfg = models[mode]
        pipe = KontextPipeline(to_bf16(fp, "cuda"), fcfg,
                               cast_floating(vp, torch.bfloat16, "cuda"), vcfg, device="cuda")
        for fn in COUNTERS.values():
            fn.launches = 0
        out = pipe(**on("cuda"), **kw)
        launches = {name: fn.launches for name, fn in COUNTERS.items()}
        update = out.float().cpu() - on("cpu")["latents"].float()
        rel = {m: rel_l2(update, refs[m]) for m in SMALL_MODES}
        print(f"[small] {mode}: 2+2-block model, 4 steps, bf16 card vs fp32 CPU plain path (same "
              f"weights{', same int8 codes' if mode != 'bf16' else ''}): update rel-L2 "
              f"{rel[mode]:.3e} (limit {SMALL_REL_L2}); against the CPU path of "
              + ", ".join(f"{m} {rel[m]:.3e}" for m in SMALL_MODES if m != mode)
              + f" ({other[mode]}'s at least {SMALL_MIN_RATIO}x); launches {launches}", flush=True)
        check(rel[mode] < SMALL_REL_L2, f"small reference {mode}: rel-L2 {rel[mode]}")
        check(rel[other[mode]] >= SMALL_MIN_RATIO * rel[mode],
              f"small reference {mode}: as near {other[mode]}'s output ({rel[other[mode]]}) "
              f"as its own ({rel[mode]})")
        for name, n in launches.items():
            check(n == wants[mode].get(name, 0),
                  f"small reference {mode}: {name} launches {n} != {wants[mode].get(name, 0)}")
    attention_mode_reference()


def attention_mode_reference():
    """w8a8-attn told apart from w8a8 and w8a8-qk8, whose models differ
    only in their attention. One forward of the small model (512 image
    tokens) in each W8A8 mode, on the card and through the CPU plain path
    at the card's precision (bf16, the same weights, int8 codes and
    inputs): the card's w8a8-attn output must lie SMALL_ATTN_RATIO times
    nearer its own mode's CPU output than w8a8's and w8a8-qk8's (K4's own
    effect is about the size of what bf16's last bits move through the
    W8A8 activation codes, hence the small ratio). And each attention call
    inside that forward, on the inputs the model gave it on the card, must
    lie INT8_MIN_RATIO times nearer K4's plain version than K1's and K3's."""
    from gpt_image_edit_tpu_torch.models.flux import model as flux_model

    rng = np.random.default_rng(8)
    s_img, s_txt = 512, 8
    ids = torch.cat([latent_image_ids(16, 16, modality=0, device="cpu"),
                     latent_image_ids(16, 16, modality=1, device="cpu")])
    inp = dict(hidden_states=torch.from_numpy(rng.standard_normal((1, s_img, 16)).astype(np.float32)),
               encoder_hidden_states=torch.from_numpy(
                   rng.standard_normal((1, s_txt, 64)).astype(np.float32)),
               pooled_projections=torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32)))
    fixed = dict(timestep=torch.tensor([0.6]), guidance=torch.tensor([3.5]), img_ids=ids,
                 pad_mask=torch.arange(s_txt + s_img)[None] != 6)

    def on(device):
        return {**{k: v.to(device, torch.bfloat16) for k, v in inp.items()},
                **{k: v.to(device) for k, v in fixed.items()}}

    modes = SMALL_MODES[1:]
    calls, refs, outs = [], {}, {}
    real = flux_model.dot_product_attention

    def recording(q, k, v, **kw):
        out = real(q, k, v, **kw)
        calls.append((q, k, v, kw.get("pad_mask"), out))
        return out

    with torch.inference_mode():
        for mode in modes:
            fp, fcfg, _, _ = small_model(mode)
            refs[mode] = apply_flux(to_bf16(fp, "cpu"), fcfg, **on("cpu")).float()
            if mode == "w8a8-attn":
                flux_model.dot_product_attention = recording
            try:
                outs[mode] = apply_flux(to_bf16(fp, "cuda"), fcfg, **on("cuda")).float().cpu()
            finally:
                flux_model.dot_product_attention = real
        rel = {m: rel_l2(outs["w8a8-attn"], refs[m]) for m in modes}
        print("[small] one forward at the card's precision (bf16 CPU plain path): w8a8-attn card "
              "against the CPU output of " + ", ".join(f"{m} {r:.3e}" for m, r in rel.items())
              + f" (w8a8's and w8a8-qk8's at least {SMALL_ATTN_RATIO}x its own); w8a8 card "
              "against " + ", ".join(f"{m} {rel_l2(outs['w8a8'], refs[m]):.3e}" for m in modes),
              flush=True)
        for m in ("w8a8", "w8a8-qk8"):
            check(rel[m] >= SMALL_ATTN_RATIO * rel["w8a8-attn"],
                  f"small forward w8a8-attn: as near {m}'s CPU output ({rel[m]}) as its own "
                  f"({rel['w8a8-attn']})")
        worst = dict(own=0.0, ratio_k1=float("inf"), ratio_k3=float("inf"))
        for q, k, v, pad, out in calls:
            own = rel_l2(out, k4.flash_attention_int8_reference(q, k, v, pad_mask=pad))
            k1 = rel_l2(out, fa.flash_attention_reference(q, k, v, pad_mask=pad))
            k3 = rel_l2(out, qk8.flash_attention_qk8_reference(q, k, v, pad_mask=pad))
            floor = max(own, 1e-30)
            worst = dict(own=max(worst["own"], own), ratio_k1=min(worst["ratio_k1"], k1 / floor),
                         ratio_k3=min(worst["ratio_k3"], k3 / floor))
    print(f"[small] its {len(calls)} attention calls on the card, on their own inputs: rel-L2 to "
          f"K4's plain version at most {worst['own']:.3e} (limit {INT8_REL_L2}); K1's plain "
          f"version at least {worst['ratio_k1']:.1f}x farther, K3's {worst['ratio_k3']:.1f}x (at "
          f"least {INT8_MIN_RATIO}x)", flush=True)
    check(len(calls) == 4 and worst["own"] <= INT8_REL_L2, "small forward: K4 inside the model")
    check(min(worst["ratio_k1"], worst["ratio_k3"]) >= INT8_MIN_RATIO,
          "small forward: the model's attention is as near K1 or K3 as K4")


# --------------------------------------------------------------------------
# phase 4: full-width edits
# --------------------------------------------------------------------------

def edit(pipe, gen, label, want, *, width, height, s_txt, valid, steps, neg=None):
    """One request through KontextPipeline.__call__. `want` maps each
    kernel to its launches per MMDiT forward on this path; every counter is
    set to 0 just before the request and read just after."""
    fcfg = pipe.flux_cfg
    req = dict(
        prompt_embeds=randn(gen, 1, s_txt, fcfg.joint_attention_dim),
        pooled_prompt_embeds=randn(gen, 1, fcfg.pooled_projection_dim),
        image=torch.rand(1, height, width, 3, generator=gen, device="cuda") * 2 - 1,
        txt_pad_mask=torch.arange(s_txt, device="cuda")[None] < valid,
    )
    cfg_factor = 1
    if neg is not None:
        n_txt, n_valid, scale = neg
        req.update(negative_prompt_embeds=randn(gen, 1, n_txt, fcfg.joint_attention_dim),
                   negative_pooled_prompt_embeds=randn(gen, 1, fcfg.pooled_projection_dim),
                   neg_txt_pad_mask=torch.arange(n_txt, device="cuda")[None] < n_valid,
                   true_cfg_scale=scale)
        cfg_factor = 2
    marks = []

    def on_step(i):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe(**req, height=height, width=width, num_inference_steps=steps,
                  generator=gen, step_callback=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    forwards = steps * cfg_factor
    check(bool(torch.isfinite(images).all()), f"{label} edit output has non-finite values")
    u8 = postprocess_to_uint8(images)
    step_s = (marks[-1] - marks[0]) / (steps - 1)
    print(f"[edit] {label} {width}x{height} S_txt={s_txt} ({valid} valid) steps={steps} "
          f"true_cfg={'yes' if neg else 'no'}: wall {wall:.3f} s; encode ~{marks[0] - t0:.3f} s, "
          f"step ~{step_s:.4f} s, decode ~{t0 + wall - marks[-1] - step_s:.3f} s; "
          f"output {u8.shape} {u8.dtype} min {u8.min()} max {u8.max()} std {u8.std():.2f}; "
          f"launches {launches} (want per forward {want}, {forwards} forwards)", flush=True)
    check(u8.shape == (1, height, width, 3) and u8.dtype == np.uint8, f"bad output {u8.shape}")
    check(u8.std() > 0, "uint8 output is constant")
    for name, n in launches.items():
        check(n == want.get(name, 0) * forwards,
              f"{label}: {name} launches {n} != {want.get(name, 0)} x {forwards}")
    return dict(wall_s=wall, step_s=step_s, launches=launches)


# --------------------------------------------------------------------------
# phase 5: where one MMDiT forward's device time goes
# --------------------------------------------------------------------------

def profile_forward(pipe, gen, label):
    """One 1024^2 MMDiT forward under torch.profiler: device time by kind."""
    from torch.profiler import ProfilerActivity, profile

    fcfg = pipe.flux_cfg
    s_txt, s_img = 512, 8192
    ids = torch.cat([latent_image_ids(64, 64, modality=0, device="cuda"),
                     latent_image_ids(64, 64, modality=1, device="cuda")], dim=0)
    kw = dict(hidden_states=randn(gen, 1, s_img, fcfg.in_channels),
              encoder_hidden_states=randn(gen, 1, s_txt, fcfg.joint_attention_dim),
              pooled_projections=randn(gen, 1, fcfg.pooled_projection_dim),
              timestep=torch.full((1,), 0.5, device="cuda"), img_ids=ids,
              guidance=torch.full((1,), 3.5, device="cuda"),
              pad_mask=torch.arange(s_txt + s_img, device="cuda")[None] != 400)
    with torch.inference_mode():
        apply_flux(pipe.flux_params, fcfg, **kw)  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            apply_flux(pipe.flux_params, fcfg, **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"attention (K1/K3/K4)": 0.0, "K2 ln_modulate_quant": 0.0, "int8 GEMM": 0.0,
             "bf16 GEMM": 0.0, "other": 0.0}
    per_kernel = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        name = e.key
        per_kernel.append((us, e.count, name))
        if any(t in name for t in ("flash_fwd_kernel", "flash_qk8_kernel", "flash_int8_kernel")):
            kinds["attention (K1/K3/K4)"] += us
        elif "ln_modulate_quant_kernel" in name:
            kinds["K2 ln_modulate_quant"] += us
        elif any(t in name.lower() for t in INT8_GEMM_MARKS):
            kinds["int8 GEMM"] += us
        elif any(t in name.lower() for t in ("gemm", "nvjet", "cutlass", "xmma")):
            kinds["bf16 GEMM"] += us
        else:
            kinds["other"] += us
    busy_ms = sum(kinds.values()) / 1e3
    print(f"[profile] {label}: one 1024^2 MMDiT forward: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%); "
          + "; ".join(f"{k} {v / 1e3:.2f} ms" for k, v in kinds.items()), flush=True)
    for us, n, name in sorted(per_kernel, reverse=True)[:10]:
        print(f"[profile]   {us / 1e3:9.2f} ms  x{n:<5d} {name[:110]}", flush=True)
    check(kinds["attention (K1/K3/K4)"] > 0, f"profile {label} shows no attention kernel time")
    if common._is_w8a8(pipe.flux_params["dual_blocks"]["ff"]["in"]["kernel"]):
        check(kinds["K2 ln_modulate_quant"] > 0 and kinds["int8 GEMM"] > 0,
              f"profile {label} shows no K2 or no int8 GEMM time")


# --------------------------------------------------------------------------
# phase 6: the runtime, UnivaRuntime.edit under --quantize w8a8-attn
# --------------------------------------------------------------------------

def runtime_edit(rt, label, image, prompt, *, steps, want, **kw):
    """One request through UnivaRuntime.edit. `want` maps each kernel to its
    launches in the whole request; every counter is set to 0 just before
    the request and read just after. The latents the VAE decodes must be
    finite (checked at the decoder's input)."""
    marks, finite = [], []

    def on_step(i):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    decode = rt.pipe._decode

    def checked_decode(z):
        finite.append(bool(torch.isfinite(z).all()))
        return decode(z)

    rt.pipe._decode = checked_decode
    for fn in COUNTERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        out = rt.edit(prompt, image, steps=steps, seed=11, step_callback=on_step, **kw)
    finally:
        rt.pipe._decode = decode
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {name: fn.launches for name, fn in COUNTERS.items()}
    t = rt.last_timings
    step_s = (marks[-1] - marks[0]) / (steps - 1)
    encode_s = marks[0] - (t0 + t["prefill"] + t["text_encoders"])
    decode_s = t0 + wall - marks[-1] - step_s
    u8 = np.asarray(out)
    want_size = (image.height, image.width) if kw.get("height") is None else (kw["height"],
                                                                               kw["width"])
    print(f"[runtime] {label}: {image.width}x{image.height} input, {steps} steps, "
          f"true_cfg {kw.get('true_cfg_scale', 1.0)}: joint length S = {t['joint_length']}; wall "
          f"{wall:.3f} s = prefill {t['prefill']:.3f} s + text encoders "
          f"{t['text_encoders']:.3f} s + VAE encode ~{encode_s:.3f} s + loop "
          f"{steps * step_s:.3f} s (~{step_s:.4f} s/step) + decode ~{decode_s:.3f} s; peak device "
          f"memory {peak:.2f} GiB; output {u8.shape} {u8.dtype} min {u8.min()} max {u8.max()} "
          f"std {u8.std():.2f}; launches {launches} (want {want})", flush=True)
    check(finite == [True], f"runtime {label}: non-finite latents")
    check(u8.dtype == np.uint8 and u8.shape == want_size + (3,), f"runtime {label}: bad output "
          f"{u8.shape} {u8.dtype}, want {want_size}")
    check(u8.std() > 0, f"runtime {label}: uint8 output is constant")
    for name, n in launches.items():
        check(n == want.get(name, 0), f"runtime {label}: {name} launches {n} != "
                                      f"{want.get(name, 0)}")
    return dict(wall_s=wall, step_s=step_s, launches=launches)


def runtime_phase():
    """UnivaRuntime(synthetic_full=True, quantize="w8a8-attn") answers two
    edits: a 1024^2 image, 28 steps; a 1248x832 image with true CFG 4.0, 6
    steps. Per MMDiT forward K4 57 and K2 114 launches, K3 none; K1 runs the
    ViT (once per image), the LM prefill, T5 and CLIP (each once per
    prompt)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = UnivaRuntime(synthetic_full=True, quantize="w8a8-attn")
    _ = rt.text_encoders.t5, rt.text_encoders.clip  # built now, not inside the first edit
    torch.cuda.synchronize()
    print(f"[runtime] UnivaRuntime(synthetic_full=True, quantize='w8a8-attn') built in "
          f"{time.perf_counter() - t0:.1f} s: FLUX W8A8 {params_nbytes(rt.pipe.flux_params) / 2**30:.2f}"
          f" GiB, VLM (weight-only int8) {params_nbytes(rt.qwen_params) / 2**30:.2f} GiB, T5 "
          f"{params_nbytes(rt.text_encoders.t5[1]) / 2**30:.2f} GiB, CLIP "
          f"{params_nbytes(rt.text_encoders.clip[1]) / 2**30:.2f} GiB, VAE "
          f"{params_nbytes(rt.pipe.vae_params) / 2**30:.2f} GiB; {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB allocated, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    fcfg, qcfg = rt.fcfg, rt.qcfg
    t5cfg, clipcfg = rt.text_encoders.t5_cfg, rt.text_encoders.clip_cfg
    per_fwd_k4 = fcfg.num_layers + fcfg.num_single_layers
    per_fwd_k2 = 4 * fcfg.num_layers + fcfg.num_single_layers

    def want(steps, forwards_per_step, prompts):
        return {"flash_attention_int8": per_fwd_k4 * steps * forwards_per_step,
                "fused_quant": per_fwd_k2 * steps * forwards_per_step,
                "flash_attention_fwd": qcfg.vision.depth + (qcfg.text.num_layers + t5cfg.num_layers
                                                           + clipcfg.num_layers) * prompts}

    rng = np.random.default_rng(7)
    square = Image.fromarray(rng.integers(0, 256, (1024, 1024, 3), dtype=np.uint8))
    wide = Image.fromarray(rng.integers(0, 256, (832, 1248, 3), dtype=np.uint8))
    edits = [runtime_edit(rt, "w8a8-attn 1024^2", square, "make the sky dramatic and dark",
                          steps=28, want=want(28, 1, 1)),
             runtime_edit(rt, "w8a8-attn 1248x832 true-CFG", wide,
                          "replace the red car with a blue bicycle", steps=6, want=want(6, 2, 2),
                          true_cfg_scale=4.0)]
    profile_forward(rt.pipe, torch.Generator(device="cuda").manual_seed(12), "w8a8-attn")
    return edits


def build_kernels():
    """Every kernel of the path, one nvcc per source, all started together."""
    t0 = time.perf_counter()
    paths = kernel_build.build(KERNELS)
    print(f"[build] {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name in KERNELS:
        for line in kernel_build.ptxas_report(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {name}: {line.strip()}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}", flush=True)
    build_kernels()

    measured = {"flash_attention_fwd": attention_phase(), "fused_quant": fused_quant_phase(),
                "flash_attention_qk8": qk8_phase(), "flash_attention_int8": int8_attention_phase()}
    int8_gemm_phase()
    small_reference_phase()

    # bf16: the slice-1 path, at the serving config (bf16 rope tables)
    fcfg, vcfg = dataclasses.replace(FluxConfig(), rope_dtype="bfloat16"), VaeConfig()
    n_fwd_k1 = fcfg.num_layers + fcfg.num_single_layers           # 57 attention calls
    n_fwd_k2 = 4 * fcfg.num_layers + fcfg.num_single_layers       # 114 block prologues
    t0 = time.perf_counter()
    pipe = KontextPipeline(synthetic_flux(fcfg, seed=0), fcfg, synthetic_vae(vcfg, seed=0), vcfg)
    torch.cuda.synchronize()
    print(f"[init] full-width FLUX ({fcfg.num_layers}+{fcfg.num_single_layers} blocks, "
          f"{fcfg.inner_dim} wide) + VAE, bf16, in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    want = {"flash_attention_fwd": n_fwd_k1}
    edits = [edit(pipe, gen, "bf16", want, width=1024, height=1024, s_txt=512, valid=384,
                  steps=28),
             edit(pipe, gen, "bf16", want, width=832, height=1248, s_txt=640, valid=500, steps=6,
                  neg=(640, 128, 4.0))]
    print(f"[edits] bf16: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    profile_forward(pipe, gen, "bf16")

    # W8A8: the same FLUX quantized on the card as the JAX runtime does for
    # --quantize w8a8 / w8a8-qk8; each bf16 kernel is dropped as soon as its
    # int8 form exists (in place), the VAE stays bf16
    flux, vae = pipe.flux_params, pipe.vae_params
    del pipe
    bf16_bytes = params_nbytes(flux)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quantize_params(flux, mode="w8a8", min_size=1 << 20)
    torch.cuda.synchronize()
    print(f"[quantize] FLUX W8A8 on the card in {time.perf_counter() - t0:.1f} s: "
          f"{bf16_bytes / 2**30:.2f} GiB bf16 -> {params_nbytes(flux) / 2**30:.2f} GiB; peak "
          f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} GiB above the bf16 model; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after", flush=True)
    serve = dataclasses.replace(fcfg, fuse_mod_quant="on")
    w8a8 = KontextPipeline(flux, serve, vae, vcfg)
    w8a8_qk8 = KontextPipeline(flux, dataclasses.replace(serve, attention_impl="pallas_qk8"),
                               vae, vcfg)
    torch.cuda.reset_peak_memory_stats()
    edits += [
        edit(w8a8, gen, "w8a8", {"flash_attention_fwd": n_fwd_k1, "fused_quant": n_fwd_k2},
             width=1024, height=1024, s_txt=512, valid=384, steps=28),
        edit(w8a8_qk8, gen, "w8a8-qk8", {"fused_quant": n_fwd_k2, "flash_attention_qk8": n_fwd_k1},
             width=1024, height=1024, s_txt=512, valid=384, steps=28),
        edit(w8a8_qk8, gen, "w8a8-qk8", {"fused_quant": n_fwd_k2, "flash_attention_qk8": n_fwd_k1},
             width=832, height=1248, s_txt=640, valid=500, steps=6, neg=(640, 128, 4.0)),
    ]
    print(f"[edits] W8A8: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    profile_forward(w8a8, gen, "w8a8")
    profile_forward(w8a8_qk8, gen, "w8a8-qk8")
    del w8a8, w8a8_qk8, flux, vae
    gc.collect()
    torch.cuda.empty_cache()
    edits += runtime_phase()

    sources = {"flash_attention_fwd": "gpt_image_edit_tpu/ops/pallas/flash_attention.py:54",
               "fused_quant": "gpt_image_edit_tpu/ops/pallas/fused_quant.py:30",
               "flash_attention_qk8": "gpt_image_edit_tpu/ops/pallas/flash_attention.py:383",
               "flash_attention_int8": "gpt_image_edit_tpu/ops/pallas/flash_attention.py:178"}
    tolerance = {"flash_attention_fwd": ATTN_ATOL, "fused_quant": 1,
                 "flash_attention_qk8": {"rel_l2": QK8_REL_L2, "k1_ratio": QK8_MIN_RATIO},
                 "flash_attention_int8": {"rel_l2": INT8_REL_L2,
                                          "k3_and_64_key_groups_ratio": INT8_MIN_RATIO}}
    entries = []
    for name in KERNELS:
        launches = sum(e["launches"][name] for e in edits)
        check(launches > 0, f"{name} was not launched on the main path")
        m = measured[name]
        entries.append(dict(
            name=name, route="cuda", source=f"gpt_image_edit_tpu_torch/csrc/{name}.cu",
            replaces=sources[name], launches=launches, max_abs_err=m["max_abs_err"],
            tolerance=tolerance[name], ms=m["ms"], plain_ms=m["plain_ms"], bound_ms=m["bound_ms"],
            bound_by=m["bound_by"], library_ms=m["library_ms"],
            **{key: m[key] for key in ("off_share", "rel_l2") if key in m}))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
