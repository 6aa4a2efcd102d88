"""Serving runtime: instruction + image -> edited image.

Counterpart of `gpt_image_edit_tpu.serve.runtime.UnivaRuntime` for the
single-edit path, `edit`: ChatML prompt with <image> expansion -> the
Qwen2.5-VL prefill with `output_type="denoise_embeds"` (ViT, LM, MLP2
projector) -> the T5-XXL suffix and the CLIP-L pooled row -> the
FLUX.1-Kontext pipeline (VAE encode, flow-matching loop, VAE decode) -> a
uint8 PIL image. `quantize` picks the FLUX serving mode as in the JAX
runtime: "w8a8" (K2 prologues, K1 attention), "w8a8-qk8" (K3 attention) or
"w8a8-attn" (K4 attention); None serves bf16.

Weights: no checkpoint loading yet, so `synthetic_full=True` builds the
full-size models with seeded random weights on the device (FLUX built in
bf16 and quantized in place; the VLM trunk weight-only int8, as the JAX
synthetic mode serves it; T5, CLIP and the VAE in bf16) and `tiny=True`
builds the tiny configs (fp32, the VAE in bf16). The sample noise comes from a
torch.Generator: seeded per request by `seed`, else from the runtime's own
stream (seeded at construction). `device` defaults to the card and raises
without one unless "cpu" is asked for.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Tuple

import torch
from PIL import Image

from gpt_image_edit_tpu_torch.data.chat_prep import prepare_chat_inputs
from gpt_image_edit_tpu_torch.data.image_processing import preprocess_vae_image
from gpt_image_edit_tpu_torch.data.prompter import Qwen2VLPrompter
from gpt_image_edit_tpu_torch.data.tokenizer import load_tokenizer
from gpt_image_edit_tpu_torch.models.common import cast_floating
from gpt_image_edit_tpu_torch.models.flux import FluxConfig
from gpt_image_edit_tpu_torch.models.qwen2p5vl import Qwen2p5VLConfig, apply_qwen
from gpt_image_edit_tpu_torch.models.vae import VaeConfig
from gpt_image_edit_tpu_torch.pipeline.kontext import (
    KontextPipeline,
    pick_kontext_resolution,
    postprocess_to_uint8,
)
from gpt_image_edit_tpu_torch.utils.platform import resolve_device
from gpt_image_edit_tpu_torch.utils.quantize import quantize_params
from gpt_image_edit_tpu_torch.utils.synthetic import synthetic_flux, synthetic_qwen, synthetic_vae

log = logging.getLogger("gie_torch.serve")

QUANTIZE_MODES = ("w8a8", "w8a8-qk8", "w8a8-attn")
_ATTENTION_IMPL = {"w8a8-attn": "pallas_int8", "w8a8-qk8": "pallas_qk8"}


def _later(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with {item}, a later slice "
                               "of the port (ROADMAP.md Queue 1)")


def update_size(img: Optional[Image.Image], default: int = 1024) -> Tuple[int, int]:
    """Output (height, width) from the input aspect, snapped to the Kontext
    bucket table."""
    if img is None:
        return default, default
    w, h = pick_kontext_resolution(img.width, img.height)
    return h, w


class UnivaRuntime:
    def __init__(
        self,
        model_path: Optional[str] = None,
        flux_path: Optional[str] = None,
        *,
        tiny: bool = False,
        seed: int = 0,
        quantize: Optional[str] = None,
        quantize_t5: Optional[str] = None,
        offload: bool = False,
        synthetic_full: bool = False,
        mesh=None,
        device="cuda",
    ):
        if model_path or flux_path:
            raise _later("loading a checkpoint", "M8 (checkpoints)")
        if offload:
            raise _later("offload", "M11 (offload and vae_slicing)")
        if mesh is not None:
            raise _later("mesh sharding", "M14 (parallel)")
        if quantize_t5 is not None:
            raise _later("quantize_t5", "M8 (checkpoints)")
        if quantize is not None and quantize not in QUANTIZE_MODES:
            raise ValueError(f"unknown quantize mode {quantize!r} ({' | '.join(QUANTIZE_MODES)})")
        self.device = resolve_device(device)
        self.prompter = Qwen2VLPrompter()
        self.tokenizer = load_tokenizer("fake")
        self.text_encoders = None
        self.last_timings: dict = {}
        dev = self.device
        synthetic = synthetic_full and not tiny
        if synthetic:
            log.info("building SYNTHETIC full-size weights (seeded random, on %s)", dev)
            self.qcfg, self.vcfg = Qwen2p5VLConfig(), VaeConfig()
            self.fcfg = dataclasses.replace(FluxConfig(), rope_dtype="bfloat16")
            flux_params = synthetic_flux(self.fcfg, seed=seed, device=dev)
            vae_params = synthetic_vae(self.vcfg, seed=seed + 1, device=dev)
            self.qwen_params = quantize_params(synthetic_qwen(self.qcfg, seed=seed + 2, device=dev),
                                               mode="weight_only", min_size=1 << 20)
            self.vit_pixels = 200704
            from gpt_image_edit_tpu_torch.utils.prompt_embeds import FluxTextEncoders

            self.text_encoders = FluxTextEncoders(device=dev, seed=seed + 3)
            flux_min_size = 1 << 20
        else:
            log.info("building TINY random-weight models")
            self.qcfg = Qwen2p5VLConfig.tiny()
            self.fcfg = dataclasses.replace(FluxConfig.tiny(),
                                            joint_attention_dim=self.qcfg.projector_out)
            self.vcfg = VaeConfig.tiny()
            self.qwen_params = synthetic_qwen(self.qcfg, seed=seed, device=dev, dtype=torch.float32)
            flux_params = synthetic_flux(self.fcfg, seed=seed + 1, device=dev, dtype=torch.float32)
            vae_params = cast_floating(
                synthetic_vae(self.vcfg, seed=seed + 2, device=dev, dtype=torch.float32),
                torch.bfloat16)
            self.vit_pixels = 3136
            flux_min_size = 1024  # the tiny kernels are below the serving min_size

        if quantize is not None:
            log.info("quantizing FLUX weights (w8a8)")
            quantize_params(flux_params, mode="w8a8", min_size=flux_min_size)
            if quantize in _ATTENTION_IMPL:
                self.fcfg = dataclasses.replace(self.fcfg, attention_impl=_ATTENTION_IMPL[quantize])
        self.pipe = KontextPipeline(flux_params, self.fcfg, vae_params, self.vcfg, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    # ------------------------------------------------------------------
    def _prepare_inputs(self, conversation, images: List[Image.Image], *,
                        gen_trigger: bool = False):
        """The one prompt-preprocessing path (data.chat_prep); returns
        (model_kwargs on the runtime's device, rope_deltas)."""
        kwargs, deltas = prepare_chat_inputs(self.prompter, self.tokenizer, self.qcfg, conversation,
                                             images, vit_pixels=self.vit_pixels,
                                             gen_trigger=gen_trigger)
        return {k: (v.to(self.device) if torch.is_tensor(v) else v)
                for k, v in kwargs.items()}, deltas

    @torch.inference_mode()
    def _encode_prompt(self, conversation, images: List[Image.Image]):
        """ChatML + <image> expansion -> LVLM denoise_embeds."""
        kwargs, _ = self._prepare_inputs(conversation, images, gen_trigger=True)
        embeds = apply_qwen(self.qwen_params, self.qcfg, output_type="denoise_embeds", **kwargs)
        return embeds, kwargs

    def _text_cond(self, text: str):
        """(t5_embeds | None, pooled (1, D)): the T5 suffix and the CLIP pooled
        row of the instruction when the runtime has text encoders (synthetic
        mode), else no suffix and a zero pooled row (tiny mode)."""
        if self.text_encoders is not None:
            return self.text_encoders.encode_prompt([text], 256)
        return None, torch.zeros(1, self.fcfg.pooled_projection_dim, dtype=torch.bfloat16,
                                 device=self.device)

    def _neg_cond_prefill(self, negative_prompt: str):
        """True-CFG negative branch, first half: its own prefill and pad mask."""
        neg_embeds, neg_kwargs = self._encode_prompt([{"from": "user", "value": negative_prompt}],
                                                     [])
        return neg_embeds, neg_kwargs["attention_mask"]

    def _neg_cond_text(self, negative_prompt: str, neg_embeds, neg_txt_pad_mask):
        """Second half: the text conditioning joined on. Returns bf16
        (neg_embeds, neg_pooled, neg_pad_mask)."""
        neg_t5, neg_pooled = self._text_cond(negative_prompt)
        neg_embeds, neg_txt_pad_mask = self._join_t5(neg_embeds, neg_txt_pad_mask, neg_t5)
        return (neg_embeds.to(torch.bfloat16), neg_pooled.to(torch.bfloat16), neg_txt_pad_mask)

    @staticmethod
    def _join_t5(embeds, txt_pad_mask, t5_embeds):
        """The T5 rows after the LVLM rows, all of them kept."""
        if t5_embeds is None:
            return embeds, txt_pad_mask
        embeds = torch.cat([embeds, t5_embeds.to(embeds.dtype)], dim=1)
        ones = torch.ones(1, t5_embeds.shape[1], dtype=txt_pad_mask.dtype,
                          device=txt_pad_mask.device)
        return embeds, torch.cat([txt_pad_mask, ones], dim=1)

    @staticmethod
    def _as_image_list(image) -> list:
        if isinstance(image, (list, tuple)):
            return list(image)
        return [image] if image is not None else []

    def _resolve_shapes(self, images, height, width):
        """Output (height, width) and each reference's (bh, bw) bucket."""
        first = images[0] if images else None
        if height is None or width is None:
            height, width = update_size(first)
        if self.vcfg.downscale != 8:  # tiny demo: keep it small
            height = width = 8 * self.vcfg.downscale
        buckets = []
        for im in images:
            bw, bh = pick_kontext_resolution(im.width, im.height)
            if self.vcfg.downscale != 8:
                bw = bh = height
            buckets.append((bh, bw))
        return height, width, buckets

    def _prep_edit_prefill(self, instruction: str, image=None):
        """VLM-prefill half of _prep_edit: LVLM embeds + pad mask."""
        images = self._as_image_list(image)
        conversation = [{"from": "user", "value": "<image>" * len(images) + instruction}]
        embeds, enc_kwargs = self._encode_prompt(conversation, images)
        return images, embeds, enc_kwargs["attention_mask"]

    def _prep_edit_text(self, instruction: str, images, embeds, txt_pad_mask, *,
                        height: Optional[int] = None, width: Optional[int] = None,
                        seed: Optional[int] = None) -> dict:
        """Text-encoder half of _prep_edit (T5 suffix + CLIP pooled row) plus
        the conditioning pixels, the output size and the noise generator."""
        t5_embeds, pooled = self._text_cond(instruction)
        embeds, txt_pad_mask = self._join_t5(embeds, txt_pad_mask, t5_embeds)
        height, width, buckets = self._resolve_shapes(images, height, width)
        conds = [torch.from_numpy(preprocess_vae_image(im, bh, bw))[None].to(self.device)
                 for im, (bh, bw) in zip(images, buckets)]
        if seed is not None:
            # a seeded request leaves the runtime's own stream untouched
            generator = torch.Generator(device=self.device).manual_seed(seed)
        else:
            generator = self.generator
        return {"embeds": embeds, "txt_pad_mask": txt_pad_mask, "pooled": pooled, "conds": conds,
                "height": height, "width": width, "generator": generator}

    def _prep_edit(self, instruction: str, image=None, *, height: Optional[int] = None,
                   width: Optional[int] = None, seed: Optional[int] = None) -> dict:
        """Per-request prep: LVLM embeds (+ T5 suffix), pad mask, pooled row,
        per-reference VAE-ready pixels, output size and noise generator."""
        images, embeds, txt_pad_mask = self._prep_edit_prefill(instruction, image)
        return self._prep_edit_text(instruction, images, embeds, txt_pad_mask, height=height,
                                    width=width, seed=seed)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def edit(
        self,
        instruction: str,
        image=None,  # PIL.Image, a list of them (multi-reference), or None
        *,
        steps: int = 28,
        guidance: float = 3.5,
        true_cfg_scale: float = 1.0,
        negative_prompt: str = "Generate an image.",
        height: Optional[int] = None,
        width: Optional[int] = None,
        seed: Optional[int] = None,
        step_callback=None,
        num_images_per_prompt: int = 1,
    ):
        """One edit request -> a PIL image (a list when num_images_per_prompt
        > 1). `last_timings` holds the wall seconds of its stages: the VLM
        prefills, the text encoders and the pipeline (VAE encode, the loop,
        VAE decode)."""
        self._sync()
        t0 = time.perf_counter()
        images, embeds, txt_pad_mask = self._prep_edit_prefill(instruction, image)
        neg_prefill = None
        if true_cfg_scale > 1.0:
            neg_prefill = self._neg_cond_prefill(negative_prompt)
        self._sync()
        t1 = time.perf_counter()
        prep = self._prep_edit_text(instruction, images, embeds, txt_pad_mask, height=height,
                                    width=width, seed=seed)
        neg_embeds = neg_pooled = neg_txt_pad_mask = None
        if neg_prefill is not None:
            neg_embeds, neg_pooled, neg_txt_pad_mask = self._neg_cond_text(negative_prompt,
                                                                           *neg_prefill)
        self._sync()
        t2 = time.perf_counter()
        conds = prep["conds"]
        out = self.pipe(
            prompt_embeds=prep["embeds"].to(torch.bfloat16),
            pooled_prompt_embeds=prep["pooled"].to(torch.bfloat16),
            image=None if not conds else (conds if len(conds) > 1 else conds[0]),
            height=prep["height"],
            width=prep["width"],
            num_inference_steps=steps,
            guidance_scale=guidance,
            true_cfg_scale=true_cfg_scale,
            negative_prompt_embeds=neg_embeds,
            negative_pooled_prompt_embeds=neg_pooled,
            generator=prep["generator"],
            step_callback=step_callback,
            num_images_per_prompt=num_images_per_prompt,
            txt_pad_mask=prep["txt_pad_mask"],
            neg_txt_pad_mask=neg_txt_pad_mask,
        )
        arrs = postprocess_to_uint8(out)
        t3 = time.perf_counter()
        self.last_timings = {"prefill": t1 - t0, "text_encoders": t2 - t1, "pipeline": t3 - t2,
                             "joint_length": prep["embeds"].shape[1] + self._image_tokens(prep)}
        if num_images_per_prompt > 1:
            return [Image.fromarray(a) for a in arrs]
        return Image.fromarray(arrs[0])

    def _image_tokens(self, prep) -> int:
        """Target + reference tokens of the MMDiT sequence for this request."""
        per = self.vcfg.downscale * 2  # one packed token per 2x2 latent cell
        n = (prep["height"] // per) * (prep["width"] // per)
        return n + sum((c.shape[1] // per) * (c.shape[2] // per) for c in prep["conds"])

    # ------------------------------------------------------------------
    # the JAX runtime's other entry points come with later slices
    def edit_batch(self, *a, **k):
        raise _later("edit_batch", "the rest of M9 (training slice, Queue 1)")

    def route(self, *a, **k):
        raise _later("route", "the task head (M8) and the rest of M9")

    def chat(self, *a, **k):
        raise _later("chat (and chat_turn, answer)",
                     "the VLM's KV-cache decode (the rest of M6 and M9)")

    chat_turn = answer = chat

    def edit_t5_only(self, *a, **k):
        raise _later("edit_t5_only", "the rest of M9")

    def load_text_encoders(self, *a, **k):
        raise _later("load_text_encoders", "M8 (checkpoints)")
