#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (gpt_image_edit_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernel) and the CUDA toolkit.
Phases, each of which ends the run with a non-zero exit if it fails:

1. Device: the card's name and power limit, the versions, and the build of
   every kernel of the path from the sources in this checkout.
2. Kernel vs plain: the K1 flash-attention kernel against its plain PyTorch
   version on the card, bf16, on each mask and shape it takes at serving
   (the FLUX shape with a text pad mask, a ragged length, segments, causal
   with Sq != Skv, GQA, a row with every key masked, an additive bias, a
   16,896-token sequence), with
   timings of the kernel, the plain version and one PyTorch SDPA call at the
   FLUX shape.
3. Small reference: a two-block model through KontextPipeline in bf16 on the
   card against the same weights in fp32 through the plain CPU path.
4. Edits: the full-width FLUX.1-Kontext (19 dual + 38 single blocks, 3072
   wide) and the full VAE, bf16, random weights from seed 0, answer two edit
   requests through KontextPipeline.__call__; the kernel's launch counter
   must show 57 launches per MMDiT forward.
5. Profile: one 1024^2 MMDiT forward under torch.profiler, device time by
   kind (K1, GEMMs, the rest).

It prints one {"kernels": [...]} line, then, as the last line,
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from gpt_image_edit_tpu_torch.models.common import cast_floating
from gpt_image_edit_tpu_torch.models.flux import FluxConfig, apply_flux
from gpt_image_edit_tpu_torch.models.vae import VaeConfig
from gpt_image_edit_tpu_torch.ops.kernels import flash_attention as fa
from gpt_image_edit_tpu_torch.ops.packing import latent_image_ids
from gpt_image_edit_tpu_torch.pipeline import KontextPipeline, postprocess_to_uint8
from gpt_image_edit_tpu_torch.utils.synthetic import synthetic_flux, synthetic_vae

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # H100 SXM HBM3 bandwidth
ATTN_ATOL = 1e-2           # bf16 output; the kernel rounds p to bf16 before p @ v


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


def randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


# --------------------------------------------------------------------------
# phase 2: kernel vs plain
# --------------------------------------------------------------------------

def attention_case(name, gen, b, sq, skv, hq, hkv, d, **masks):
    q = randn(gen, b, sq, hq, d)
    k = randn(gen, b, skv, hkv, d)
    v = randn(gen, b, skv, hkv, d)
    out = fa.flash_attention(q, k, v, **masks)
    ref = fa.flash_attention_reference(q, k, v, **masks)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out).all()), f"attention case {name}: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    print(f"[attn] {name}: B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} d={d} "
          f"max_abs_err={err:.3e} (atol {ATTN_ATOL})", flush=True)
    check(err <= ATTN_ATOL, f"attention case {name}: max abs err {err} > {ATTN_ATOL}")
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
    # (h) the long-sequence regime the Pallas grid kernel covered (K/V over
    # 8 MB per head): 512 text + four 1024^2 images, S = 16,896
    s = 512 + 4 * 4096
    q, k, v, _, _, _ = attention_case("h_long_16896", gen, 1, s, s, 24, 24, 128)
    long_ms = time_ms(lambda: fa.flash_attention(q, k, v), iters=5)
    flops = 4 * 24 * s * s * 128
    print(f"[attn] h_long_16896 timing: kernel {long_ms:.4f} ms ({flops / long_ms / 1e9:.1f} "
          f"TFLOP/s), bound {flops / PEAK_BF16_FLOPS * 1e3:.4f} ms (operations)", flush=True)
    return dict(max_abs_err=err_a, ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_s * 1e3, bound_by=bound_by)


# --------------------------------------------------------------------------
# phase 3: a small model on the card against the plain CPU path
# --------------------------------------------------------------------------

def small_reference_phase():
    fcfg = FluxConfig(in_channels=16, out_channels=16, num_layers=2, num_single_layers=2,
                      attention_head_dim=128, num_attention_heads=2, joint_attention_dim=64,
                      pooled_projection_dim=32)
    vcfg = VaeConfig.tiny()
    fp = synthetic_flux(fcfg, seed=3, device="cpu", dtype=torch.float32)
    vp = synthetic_vae(vcfg, seed=4, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(5)
    req = dict(
        prompt_embeds=torch.from_numpy(rng.standard_normal((1, 8, 64)).astype(np.float32)),
        pooled_prompt_embeds=torch.from_numpy(rng.standard_normal((1, 32)).astype(np.float32)),
        image=torch.from_numpy(rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)),
        latents=torch.from_numpy(rng.standard_normal((1, 64, 16)).astype(np.float32)),
        txt_pad_mask=torch.tensor([[1] * 6 + [0] * 2], dtype=torch.bool),
    )
    kw = dict(height=64, width=64, num_inference_steps=4, output_type="latent")
    ref = KontextPipeline(fp, fcfg, vp, vcfg, device="cpu")(**req, **kw)
    req_gpu = {n: (x.to("cuda", torch.bfloat16) if x.is_floating_point() else x.cuda())
               for n, x in req.items()}
    out = KontextPipeline(cast_floating(fp, torch.bfloat16, "cuda"), fcfg,
                          cast_floating(vp, torch.bfloat16, "cuda"), vcfg, device="cuda")(**req_gpu, **kw)
    rel = ((out.float().cpu() - ref).norm() / ref.norm()).item()
    print(f"[small] 2+2-block model, 4 steps, bf16 card vs fp32 CPU plain path: "
          f"latent rel-L2 {rel:.3e} (limit 5e-2)", flush=True)
    check(rel < 5e-2, f"small reference: rel-L2 {rel}")


# --------------------------------------------------------------------------
# phase 4: full-width edits
# --------------------------------------------------------------------------

def edit(pipe, gen, *, width, height, s_txt, valid, steps, neg=None):
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

    before = fa.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = pipe(**req, height=height, width=width, num_inference_steps=steps,
                  generator=gen, step_callback=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.flash_attention.launches - before
    want = (fcfg.num_layers + fcfg.num_single_layers) * steps * cfg_factor
    check(bool(torch.isfinite(images).all()), "edit output has non-finite values")
    u8 = postprocess_to_uint8(images)
    step_s = (marks[-1] - marks[0]) / (steps - 1)
    print(f"[edit] {width}x{height} S_txt={s_txt} ({valid} valid) steps={steps} "
          f"true_cfg={'yes' if neg else 'no'}: wall {wall:.3f} s; encode ~{marks[0] - t0:.3f} s, "
          f"step ~{step_s:.4f} s, decode ~{t0 + wall - marks[-1] - step_s:.3f} s; "
          f"output {u8.shape} {u8.dtype} min {u8.min()} max {u8.max()} std {u8.std():.2f}; "
          f"K1 launches {launches} (want {want})", flush=True)
    check(u8.shape == (1, height, width, 3) and u8.dtype == np.uint8, f"bad output {u8.shape}")
    check(u8.std() > 0, "uint8 output is constant")
    check(launches == want, f"K1 launches {launches} != {want}")
    return dict(wall_s=wall, step_s=step_s, launches=launches)


# --------------------------------------------------------------------------
# phase 5: where one MMDiT forward's device time goes
# --------------------------------------------------------------------------

def profile_forward(pipe, gen):
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
    kinds = {"K1 flash_fwd_kernel": 0.0, "GEMM": 0.0, "other": 0.0}
    per_kernel = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        name = e.key
        per_kernel.append((us, e.count, name))
        if "flash_fwd_kernel" in name:
            kinds["K1 flash_fwd_kernel"] += us
        elif any(t in name.lower() for t in ("gemm", "nvjet", "cutlass", "xmma")):
            kinds["GEMM"] += us
        else:
            kinds["other"] += us
    busy_ms = sum(kinds.values()) / 1e3
    print(f"[profile] one 1024^2 MMDiT forward: wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%); "
          + "; ".join(f"{k} {v / 1e3:.2f} ms" for k, v in kinds.items()), flush=True)
    for us, n, name in sorted(per_kernel, reverse=True)[:8]:
        print(f"[profile]   {us / 1e3:9.2f} ms  x{n:<5d} {name[:110]}", flush=True)
    check(kinds["K1 flash_fwd_kernel"] > 0, "profile shows no K1 time")


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
    t0 = time.perf_counter()
    lib_path = fa.build()
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {line.strip()}", flush=True)

    k1 = attention_phase()
    small_reference_phase()

    fcfg, vcfg = FluxConfig(), VaeConfig()
    t0 = time.perf_counter()
    pipe = KontextPipeline(synthetic_flux(fcfg, seed=0), fcfg, synthetic_vae(vcfg, seed=0), vcfg)
    torch.cuda.synchronize()
    print(f"[init] full-width FLUX ({fcfg.num_layers}+{fcfg.num_single_layers} blocks, "
          f"{fcfg.inner_dim} wide) + VAE, bf16, in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    e1 = edit(pipe, gen, width=1024, height=1024, s_txt=512, valid=384, steps=28)
    e2 = edit(pipe, gen, width=832, height=1248, s_txt=640, valid=500, steps=6,
              neg=(640, 128, 4.0))
    launches = fa.flash_attention.launches
    check(launches == e1["launches"] + e2["launches"], "K1 launches outside the edits")
    print(f"[edits] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_forward(pipe, gen)

    entry = dict(name="flash_attention_fwd", route="cuda",
                 source="gpt_image_edit_tpu_torch/csrc/flash_attention_fwd.cu",
                 replaces="gpt_image_edit_tpu/ops/pallas/flash_attention.py:54",
                 launches=launches, max_abs_err=k1["max_abs_err"], max_err=k1["max_abs_err"],
                 tolerance=ATTN_ATOL, ms=k1["ms"], plain_ms=k1["plain_ms"],
                 bound_ms=k1["bound_ms"], bound_by=k1["bound_by"], library_ms=k1["library_ms"])
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
